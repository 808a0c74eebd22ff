"""Per ``predict_many`` call: its host span minus the device's busy time inside it."""
from portbench.readers import host_minus_device_ms


def read(run):
    return host_minus_device_ms(run, "portbench.predict_many")
