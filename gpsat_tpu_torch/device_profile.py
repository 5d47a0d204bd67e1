"""Device time of CUDA kernels by name, from torch.profiler.

Imports torch alone: tools/time_port_kernels.py loads this file from its own
checkout while it times the kernels of another.
"""

import torch

# route mega's own kernels (csrc/gp_sgpr_vg.cu) by phase
GV_GROUPS = {
    "products": ("gv_t1_kernel", "gv_p_kernel", "gv_t2_kernel",
                 "gv_kbar_uu_kernel"),
    "p5": ("gv_c_kernel", "gv_upper_matvec_kernel", "gv_scalars_kernel"),
    "rest": ("gv_kuu_kernel", "gv_add_identity", "gv_finish_kernel"),
}


def device_times(prof):
    """{kernel name: (device microseconds, calls)} of the CUDA kernels."""
    out = {}
    for evt in prof.key_averages():
        us = evt.device_time_total
        if us and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = (float(us), int(evt.count))
    return out


def base_name(key):
    """A profiler kernel key without "void ", its arguments and its template
    argument list (which may hold spaces: "gp_cholinv_diag_kernel<CiKernel<1>
    >")."""
    name = key.split("(")[0].strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("<")[0]


def by_gv_group(kernels, groups=GV_GROUPS):
    """{group: device ms} summed over the CUDA kernels of device_times()."""
    out = {g: 0.0 for g in groups}
    for key, (us, _) in kernels.items():
        for g, names in groups.items():
            if base_name(key) in names:
                out[g] += us * 1e-3
    return out


def gv_share_ms(fn, reps=5, groups=GV_GROUPS):
    """{group: device ms per call} of route mega's own kernels in fn() (one
    sgpr_vg_mega call), by torch.profiler over `reps` warm calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {g: ms / reps
            for g, ms in by_gv_group(device_times(prof), groups).items()}
