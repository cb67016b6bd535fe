from .engine import Request, Result, ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine", "Request", "Result"]
