"""Seconds of the port's host partition build (``partition_2d``), by the
harness's host clock around the call."""


def read(t):
    return t["partition_s"]
