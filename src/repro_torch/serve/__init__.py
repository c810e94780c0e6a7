from repro_torch.serve.engine import Request, RequestResult, ServeEngine, ServeStats

__all__ = ["Request", "RequestResult", "ServeEngine", "ServeStats"]
