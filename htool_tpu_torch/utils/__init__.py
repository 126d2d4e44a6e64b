from .device import get_default_device, resolve_device, set_default_device
from .logger import Logger, LogLevel, logger
from .options import SolverOptions
from .precision import set_full_precision

__all__ = ["resolve_device", "set_default_device", "get_default_device", "Logger", "LogLevel", "logger", "SolverOptions", "set_full_precision"]
