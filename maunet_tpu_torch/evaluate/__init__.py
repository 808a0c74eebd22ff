"""Checkpoint loading, on-device metrics and the checkpoint evaluator."""
