"""Small shared constants and helpers."""
