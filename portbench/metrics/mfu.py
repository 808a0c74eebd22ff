"""The model's operations over the traced window as a percent of the bf16 peak."""
from portbench.readers import mfu as read  # noqa: F401
