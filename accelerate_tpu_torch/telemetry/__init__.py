from .serving_metrics import ServingMetrics

__all__ = ["ServingMetrics"]
