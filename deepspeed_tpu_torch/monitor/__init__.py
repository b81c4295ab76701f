from .telemetry import ServingTelemetry, percentile

__all__ = ["ServingTelemetry", "percentile"]
