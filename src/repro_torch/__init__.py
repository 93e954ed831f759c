"""repro_torch — the DBCSR reproduction ported to PyTorch and
hand-written CUDA kernels for Hopper (H100, sm_90a).

It sits beside the JAX package ``repro``, which stays the reference,
and mirrors its layout:

    repro_torch.core        blocking, stack generation, the fused stack
                            executor (single and batched), densification,
                            the Cannon schedule, distributed_matmul,
                            distributed_matmul_batched and DBCSRMatrix
                            (dbcsr, with multiply_batched)
    repro_torch.kernels     CUDA kernels (smm, tiled_matmul, grouped_gemm,
                            decode_attention), each with a plain PyTorch
                            version and a launch counter
    repro_torch.sparsity    block norms, the filter_eps predicates and the
                            rank rebalance permutation
    repro_torch.planner     the cost-model multiply planner
                            (algorithm="auto", fused=None) and its
                            calibration on the card
    repro_torch.configs     the LM zoo's model configurations (copied)
    repro_torch.models      dense-attention LMs: params, norms, RoPE,
                            attention, FFN, segments, caches, forward,
                            carry-over of the JAX package's weights
    repro_torch.serve       MultiplyService, continuous batching of
                            multiply requests; LM prefill_step and
                            decode_step
    repro_torch.examples    runnable examples (serve_decode)
    repro_torch.robustness  error taxonomy, NaN/Inf tripwires, request
                            validation
    repro_torch.obs         the metrics registry
    repro_torch.launch      the process mesh (make_mesh), partition specs,
                            the production mesh and the H100's roofline
                            constants, the cost counter and the dry-run

It imports torch and numpy, never jax and never ``repro``.  Entry points
run on the CUDA device unless the caller asks for the CPU
(``make_mesh(..., device="cpu")``, ``model_init(..., device="cpu")``).
"""

__version__ = "0.1.0"
