from .precision import set_full_precision

__all__ = ["set_full_precision"]
