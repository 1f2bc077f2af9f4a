"""Hardware constants: TPU v5e, the reference's part (197 TFLOP/s bf16,
819 GB/s HBM, ~50 GB/s/link ICI, 16 GB HBM), which the parity tests
price with; and the NVIDIA H100 SXM the port serves on.

The perfmodel is calibrated to neither the H100 nor the port's kernels:
on the H100 its durations steer the ARM's profile, not a measurement."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link
    dcn_bw: float              # bytes/s per chip, cross-pod
    hbm_bytes: int             # capacity per chip
    # host-side per-step scheduling cost (hidden under async scheduling)
    sched_overhead_s: float = 2e-3
    # device-side per-program dispatch latency
    launch_overhead_s: float = 50e-6

    @property
    def balance(self) -> float:
        """Machine balance: FLOPs per byte at the roofline ridge."""
        return self.peak_flops / self.hbm_bw


TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    dcn_bw=25e9,
    hbm_bytes=16 * 1024 ** 3,
)


H100 = HardwareSpec(
    name="h100_sxm",
    # bf16 dense tensor-core peak, NVIDIA H100 SXM data sheet
    peak_flops=989e12,
    # HBM3 bandwidth, NVIDIA H100 SXM data sheet
    hbm_bw=3.35e12,
    # NVLink 4, one direction (900 GB/s both ways), data sheet.  This and
    # dcn_bw price multi-chip topologies only; the colocated one-card
    # path reads neither.
    ici_bw=450e9,
    # one 400 Gb/s NDR InfiniBand port per GPU (DGX H100)
    dcn_bw=50e9,
    # the data sheet's 80 GB, a little below the ~85.5e9 bytes the card
    # reports, so the KV pool sized from it leaves room for activations
    hbm_bytes=80 * 10 ** 9,
)
