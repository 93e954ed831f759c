"""Cost-model multiply planner (the paper's driver layer), a copy of the
JAX package's ``planner`` with constants measured on the H100.

    from repro_torch.planner import plan_multiply
    plan = plan_multiply(4096, 4096, 4096, blocks=(64, 64, 64),
                         mesh_shape=(4, 4), occupancy=0.2)
    print(plan.explain())

``distributed_matmul(algorithm="auto")``, ``dbcsr.multiply``,
``multiply_batched(fused=None)`` and ``MultiplyService`` route through
``plan_multiply`` / ``plan_multiply_batched``; ``calibrate`` measures
the cost-model constants on the card or fits them from the port's bench
artifacts.
"""
from .cost_model import (ALGORITHMS, BATCHED_ALGORITHMS, DEFAULT_HARDWARE,
                         CandidateCost, HardwareModel, Problem,
                         candidate_cost, enumerate_candidates,
                         ts_crossover_ratio)
from .calibrate import (get_hardware_model, invalidate_cache, micro_calibrate,
                        save_calibration)
from .plan import (BatchedMultiplyPlan, MultiplyPlan, plan_cache_clear,
                   plan_cache_info, plan_cache_stats, plan_multiply,
                   plan_multiply_batched)

__all__ = [
    "ALGORITHMS", "BATCHED_ALGORITHMS", "DEFAULT_HARDWARE", "CandidateCost",
    "HardwareModel", "Problem", "candidate_cost", "enumerate_candidates",
    "ts_crossover_ratio", "get_hardware_model", "invalidate_cache",
    "micro_calibrate", "save_calibration", "MultiplyPlan",
    "BatchedMultiplyPlan", "plan_cache_clear", "plan_cache_info",
    "plan_cache_stats", "plan_multiply", "plan_multiply_batched",
]
