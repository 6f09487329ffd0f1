"""Model zoo of the port (``transformer``)."""

from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

__all__ = ["TinyCausalLM", "load_jax_params"]
