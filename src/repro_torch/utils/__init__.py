from repro_torch.utils.hashing import rendezvous_owner
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer, Stopwatch

__all__ = ["get_logger", "Timer", "Stopwatch", "rendezvous_owner"]
