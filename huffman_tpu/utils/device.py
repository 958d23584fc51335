"""Device probing and error surfaces.

Counterpart of the reference's CUDA init/guard layer: InitCUDA's device
enumeration and pick (reference: cuda_helpers.h:11-38) and the
CUDA_SAFE_CALL / CUT_CHECK_ERROR exit-on-error macros
(reference: cutil.h:781-838).  JAX surfaces device errors as exceptions
already, so the guard layer reduces to explicit probes with readable
messages — fail fast per host, no elasticity (SURVEY.md section 5,
failure-detection row: codec, not a training job).
"""

from __future__ import annotations

import jax


class DeviceError(RuntimeError):
    pass


def probe_devices(platform: str | None = None) -> list:
    """Enumerate usable devices, raising a readable error if none.

    Reference parity: InitCUDA prints the device count and picks device 0,
    exiting if none support the required capability (cuda_helpers.h:16-35).
    """
    try:
        devs = jax.devices(platform) if platform else jax.devices()
    except RuntimeError as e:
        raise DeviceError(f"no {platform or 'default'} devices: {e}") from e
    if not devs:
        raise DeviceError(f"no {platform or 'default'} devices found")
    return devs


def describe_devices() -> str:
    devs = probe_devices()
    lines = [f"{len(devs)} device(s), backend={jax.default_backend()}"]
    for d in devs:
        lines.append(f"  [{d.id}] {d.device_kind} (process {d.process_index})")
    return "\n".join(lines)


def device_memory_stats() -> dict:
    """Best-effort per-device memory stats (empty where unsupported)."""
    out = {}
    for d in probe_devices():
        try:
            out[d.id] = d.memory_stats()
        except Exception:
            out[d.id] = {}
    return out
