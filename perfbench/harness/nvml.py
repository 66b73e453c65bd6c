"""The card's total-energy counter and power limit, read through NVML's C
library (libnvidia-ml.so.1, installed with the card's kernel module) with ctypes."""
from __future__ import annotations

import ctypes


class Nvml:
    """Open NVML for the card with `uuid` (torch's device uuid), or index 0.
    `energy_mj()` is the card's energy counter, in mJ."""

    def __init__(self, uuid: str | None = None):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        ptr = ctypes.POINTER
        for name, args in (("nvmlInit_v2", []), ("nvmlShutdown", []),
                           ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, ptr(ctypes.c_void_p)]),
                           ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, ptr(ctypes.c_void_p)]),
                           ("nvmlDeviceGetTotalEnergyConsumption",
                            [ctypes.c_void_p, ptr(ctypes.c_ulonglong)]),
                           ("nvmlDeviceGetEnforcedPowerLimit",
                            [ctypes.c_void_p, ptr(ctypes.c_uint)])):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        self._check(self.lib.nvmlInit_v2(), "nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        rc = 1
        if uuid:
            rc = self.lib.nvmlDeviceGetHandleByUUID(
                ctypes.c_char_p(uuid.encode()), ctypes.byref(self.handle))
        if rc != 0:
            self._check(self.lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(0), ctypes.byref(self.handle)), "nvmlDeviceGetHandleByIndex_v2")

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} returned NVML error {rc}")

    def energy_mj(self) -> int:
        out = ctypes.c_ulonglong()
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(out)), "nvmlDeviceGetTotalEnergyConsumption")
        return int(out.value)

    def power_limit_w(self) -> float:
        out = ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetEnforcedPowerLimit(
            self.handle, ctypes.byref(out)), "nvmlDeviceGetEnforcedPowerLimit")
        return out.value / 1000.0

    def close(self) -> None:
        self.lib.nvmlShutdown()


def card_uuid(device_index: int = 0) -> str | None:
    import torch
    uuid = getattr(torch.cuda.get_device_properties(device_index), "uuid", None)
    if uuid is None:
        return None
    s = str(uuid)
    return s if s.startswith("GPU-") else f"GPU-{s}"
