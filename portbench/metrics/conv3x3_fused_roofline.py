"""Kernel A's roofline share: its bound at the cell's launch shapes over its kernel time."""
from portbench.readers import a_roofline as read  # noqa: F401
