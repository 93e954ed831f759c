"""The LM zoo's dense-attention serving path, ported from
``repro.models``: ``common`` (params, norms, RoPE, activations),
``attention`` (GQA, blockwise prefill, the decode kernel), ``ffn``,
``transformer`` (segments, caches, forward) and ``convert`` (carry-over
of the JAX package's parameters and caches)."""
