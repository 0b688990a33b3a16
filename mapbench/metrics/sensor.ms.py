"""Host ms of the sensor model's call (the function that the cell's sensor
module names as its SPAN), per frame; the call returns before the device
has finished."""


def read(t):
    return t.mean_ms("sensor")
