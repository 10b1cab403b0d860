"""Event data pipeline in PyTorch: simulator, trajectory, aggregation."""
