from .engine import Request, RequestResult, ServeEngine

__all__ = ["Request", "RequestResult", "ServeEngine"]
