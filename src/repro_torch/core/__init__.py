"""The paper's engine: distributed blocked matmul.

    from repro_torch.core import dbcsr
    from repro_torch.core.multiply import distributed_matmul
    from repro_torch.core.multiply_batched import distributed_matmul_batched
"""
from .blocking import BlockLayout, GridSpec
from .multiply import distributed_matmul
from .cannon import (cannon_matmul, build_cannon_schedule,
                     cannon_step_masks, cannon_step_norms)
from .schedule import (Schedule, execute_schedule, DEFAULT_PIPELINE_DEPTH,
                       resolve_pipeline_depth)
from .densify import densify, undensify, to_blocks, from_blocks
from .engine import (ExecutorPlan, build_executor_plan, execute_plan,
                     stack_executor)
from .stacks import build_stacks, pad_plans, StackPlan, STACK_SIZE

__all__ = [
    "BlockLayout", "GridSpec", "distributed_matmul", "cannon_matmul",
    "densify", "undensify", "to_blocks", "from_blocks",
    "build_stacks", "pad_plans", "StackPlan", "STACK_SIZE",
    "ExecutorPlan", "build_executor_plan", "execute_plan", "stack_executor",
    "Schedule", "execute_schedule", "DEFAULT_PIPELINE_DEPTH",
    "resolve_pipeline_depth", "build_cannon_schedule",
    "cannon_step_masks", "cannon_step_norms",
]
