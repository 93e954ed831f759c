"""The LM zoo's serving path, ported from ``repro.models``: ``common``
(params, norms, RoPE, activations), the mixers ``attention`` (GQA,
blockwise prefill, the decode kernel), ``mla``, ``mamba`` and ``rwkv6``,
the feed-forwards ``ffn`` and ``moe``, ``transformer`` (segments, caches,
forward) and ``convert`` (carry-over of the JAX package's parameters and
caches)."""
