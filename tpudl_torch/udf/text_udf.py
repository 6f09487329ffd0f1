"""register_text_udfs — the LM trio as SQL UDFs.

Port of ``tpudl/udf/text_udf.py``: one call registers ``generate``,
``embed`` and, with ``classes``, ``classify`` (optionally prefixed) over
a string column, each backed by the port's
:class:`~tpudl_torch.ml.lm.LMGenerator` / ``LMFeaturizer`` /
``LMClassifier`` built ONCE at registration on ``device`` (default
``"cuda"``), so repeated queries reuse the loaded model and the per-batch
functions cached on it:

    register_text_udfs(model=lm, weights=params, tokenizer=tok, max_new=8)
    sql("SELECT embed(text) AS v FROM docs", {"docs": frame})

On the card every full-sequence forward under ``embed`` and ``classify``
runs the flash forward kernel (``csrc/flash_attn_fwd.cu``) in each
decoder block; ``generate``'s KV-cache decode does not. Each call is
counted as makeGraphUDF's are (``udf.<name>.calls``, ``.rows``,
``.seconds``). ``mesh`` and ``tp=True`` raise through the stages
(ROADMAP Queue 1, 'Training, rest' and 'LM parallelism').
"""

from __future__ import annotations

from tpudl_torch.udf.registry import UDF, metered, register_udf

__all__ = ["register_text_udfs"]


# copied from tpudl/udf/text_udf.py:_wrap, through the shared metered
def _wrap(udf_name: str, transformer, input_col: str, out_col: str,
          register: bool) -> UDF:
    frame_fn = metered(udf_name, transformer.transform)
    if register:
        return register_udf(udf_name, frame_fn, input_col, out_col)
    return UDF(str(udf_name), frame_fn, input_col, out_col)


def register_text_udfs(*, model, weights, tokenizer,
                       input_col: str = "text", prefix: str = "",
                       max_new: int = 16, temperature: float = 0.0,
                       seed: int = 0, classes=None, max_len=None,
                       prompt_buckets="pow2", batch_size: int = 32,
                       device="cuda", mesh=None, tp: bool = False,
                       register: bool = True) -> list[UDF]:
    """Register the LM UDF family over ``model``/``weights``/``tokenizer``
    (as the stages take them): ``{prefix}generate`` (→ completion
    string), ``{prefix}embed`` (→ pooled hidden vector) and, with
    ``classes=[...]``, ``{prefix}classify`` (→ label string).
    ``input_col`` names the string column the stages read; SQL's
    ``fn(col)`` renames the bound column to it. ``register=False`` builds
    and returns the UDFs without filing them. Returns the UDFs in
    registration order."""
    from tpudl_torch.ml.lm import LMClassifier, LMFeaturizer, LMGenerator

    common = dict(inputCol=input_col, model=model, weights=weights,
                  tokenizer=tokenizer, promptBuckets=prompt_buckets,
                  batchSize=batch_size, device=device, mesh=mesh, tp=tp)
    stages = [("generate", LMGenerator, dict(maxNew=max_new,
                                             temperature=temperature,
                                             seed=seed)),
              ("embed", LMFeaturizer, dict(maxLen=max_len))]
    if classes:
        stages.append(("classify", LMClassifier,
                       dict(classes=classes, maxLen=max_len)))
    out = []
    for what, cls, kw in stages:
        name = f"{prefix}{what}"
        stage = cls(outputCol=f"{name}_out", **common, **kw)
        out.append(_wrap(name, stage, input_col, f"{name}_out", register))
    return out
