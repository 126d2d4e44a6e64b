from .device import get_default_device, resolve_device, set_default_device
from .logger import Logger, LogLevel, logger
from .options import SolverOptions
from .precision import full_precision, set_full_precision
from .profiling import Timer, annotate, device_trace

__all__ = ["resolve_device", "set_default_device", "get_default_device", "Logger", "LogLevel", "logger", "SolverOptions", "set_full_precision", "full_precision",
           "Timer", "annotate", "device_trace"]
