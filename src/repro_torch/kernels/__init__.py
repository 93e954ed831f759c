"""Hand-written CUDA kernels for the compute hot spots, one package per
kernel of the JAX package's Pallas set:

    smm/          LIBCUSMM analogue: stack-driven batched small GEMM
                  (+ autotune.py, the winners-table lookup)
    tiled_matmul/ the densified path's dense GEMM
    grouped_gemm/ the batched densified path's grouped GEMM, plus the
                  one-launch fused stack processor of the batched
                  blocked path
    decode_attention/ single-token GQA attention over the KV cache, the
                  LM decode step's attention

Each package: ops.py (the wrapper: checks, launch, launch counter),
ref.py (the plain PyTorch version the wrapper takes for CPU tensors).
The CUDA sources live in ``repro_torch/csrc`` (tiled_matmul and
grouped_gemm share one GEMM body, ``gemm_tile.cuh``); ``_build.py`` compiles
and loads them on first use.
"""
