from .logger import Logger, LogLevel, logger
from .options import SolverOptions
from .precision import set_full_precision

__all__ = ["Logger", "LogLevel", "logger", "SolverOptions", "set_full_precision"]
