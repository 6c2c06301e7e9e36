"""K1 (csrc/nms.cu) against its roofline: the least time the NMS problems
of the served batches need (bytes at the HBM rate or IoU tests at the
float32 rate, harness/work.py), over K1's device time per launch in the
trace."""

# the kernels of csrc/nms.cu's launches
K1_KERNELS = ("nms_block_kernel", "nms_mask_kernel", "nms_sweep_kernel",
              "nms_sweep_long_kernel")


def read(run):
    s = run.trace_summary
    n = run.launches.get("k1_nms", 0)
    if run.entry != "serve" or not s or not n or not run.k1_bound_ms:
        return None
    secs = sum(v[0] for name, v in s["kernels"].items()
               if any(k in name for k in K1_KERNELS))
    if secs <= 0:
        return None
    calls = n * run.cell["traffic"]["trace_requests"]
    return 100.0 * run.k1_bound_ms / (secs * 1e3 / calls)
