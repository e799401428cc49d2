from .cvsr import CVSRV8

__all__ = ["CVSRV8"]
