"""Stand-in for the port's kernel library: the reference runs every pair
operation through its plain twin (`pair_ops._device_kind` answers "cpu" on
every device), so nothing here is ever loaded."""

import ctypes


class SweepParams(ctypes.Structure):
    _fields_ = []


def load():
    raise RuntimeError("the reference runs no hand-written kernel")


def check(code: int, what: str):
    raise RuntimeError("the reference runs no hand-written kernel")
