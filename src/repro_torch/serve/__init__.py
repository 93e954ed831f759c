"""Serving: ``MultiplyService``, the continuous-batching request layer
over ``dbcsr.multiply_batched``."""
from .multiply_service import (MultiplyService, PendingRequest,
                               TicketPendingError, UnknownTicketError)

__all__ = ["MultiplyService", "PendingRequest", "TicketPendingError",
           "UnknownTicketError"]
