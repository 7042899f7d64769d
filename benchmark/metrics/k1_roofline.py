"""The roll kernel's share of its roofline, in %: the least time its
launches of the traced window could take, the bytes they need (each input
byte read once, each output byte written once, from the launch shapes) at
the card's published memory bandwidth, over the kernel's device time in
the trace."""
from benchmark import flops

KERNEL = "roll_channels_kernel"


def read(run):
    summary, peaks = run["trace"], flops.peaks(run["device_name"])
    if summary is None or peaks is None or not run["k1_launches"]:
        return None
    seconds = sum(s for name, s in summary["kernel_s"].items()
                  if KERNEL in name)
    if seconds <= 0:
        return None
    need = sum(flops.roll_bytes(*shape) for shape in run["k1_launches"])
    return 100.0 * need / peaks["hbm_bytes_per_s"] / seconds
