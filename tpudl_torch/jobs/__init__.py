"""Job plumbing for the port: the retry policy that paces gang restarts
(:mod:`tpudl_torch.jobs.retry`)."""

from tpudl_torch.jobs.retry import RetryPolicy, is_fatal

__all__ = ["RetryPolicy", "is_fatal"]
