"""Serving: ``MultiplyService``, the continuous-batching request layer
over ``dbcsr.multiply_batched``; and LM serving, ``prefill.prefill_step``
and ``engine.init_serve_state`` / ``engine.decode_step``."""
from .multiply_service import (MultiplyService, PendingRequest,
                               TicketPendingError, UnknownTicketError)

__all__ = ["MultiplyService", "PendingRequest", "TicketPendingError",
           "UnknownTicketError"]
