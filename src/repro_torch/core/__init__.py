"""The paper's engine: distributed blocked matmul.

    from repro_torch.core import dbcsr
    from repro_torch.core.multiply import distributed_matmul
    from repro_torch.core.multiply_batched import distributed_matmul_batched
"""
from .blocking import BlockLayout, GridSpec
from .multiply import distributed_matmul
from .cannon import (cannon_matmul, build_cannon_schedule,
                     cannon_step_masks, cannon_step_norms)
from .cannon25d import cannon25d_matmul, build_cannon25d_schedule
from .tall_skinny import (tall_skinny_matmul, build_ts_schedule,
                          ts_step_masks, ts_step_norms, classify_shape,
                          ts_classify_ratio, DEFAULT_TS_RATIO)
from .summa import (summa_matmul, build_summa_schedule,
                    build_summa_gather_schedule, summa_step_masks,
                    summa_gather_masks, summa_step_norms,
                    summa_gather_norms)
from .schedule import (Schedule, execute_schedule, DEFAULT_PIPELINE_DEPTH,
                       resolve_pipeline_depth)
from .densify import densify, undensify, to_blocks, from_blocks
from .engine import (ExecutorPlan, build_executor_plan, execute_plan,
                     stack_executor)
from .stacks import build_stacks, pad_plans, StackPlan, STACK_SIZE

__all__ = [
    "BlockLayout", "GridSpec", "distributed_matmul", "cannon_matmul",
    "cannon25d_matmul", "tall_skinny_matmul", "classify_shape",
    "ts_classify_ratio", "DEFAULT_TS_RATIO",
    "summa_matmul", "densify", "undensify", "to_blocks", "from_blocks",
    "build_stacks", "pad_plans", "StackPlan", "STACK_SIZE",
    "ExecutorPlan", "build_executor_plan", "execute_plan", "stack_executor",
    "Schedule", "execute_schedule", "DEFAULT_PIPELINE_DEPTH",
    "resolve_pipeline_depth", "build_cannon_schedule",
    "build_cannon25d_schedule", "build_summa_schedule",
    "build_summa_gather_schedule", "build_ts_schedule",
    "cannon_step_masks", "summa_step_masks", "summa_gather_masks",
    "ts_step_masks", "cannon_step_norms", "summa_step_norms",
    "summa_gather_norms", "ts_step_norms",
]
