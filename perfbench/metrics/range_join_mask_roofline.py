"""``range_join_mask``'s share of its roofline: the least time the window's
logical joins on it need (``perfbench/roofline.py``: bytes over the HBM
bandwidth or compares over the compare rate, whichever is larger) over the
profiler's device time of the kernel, summed over the window's launches."""

NAME, UNIT, BETTER, SOURCE = "range_join_mask_roofline", "%", "higher", "device_trace"
LAYER, MOVES = "kernels/csrc/range_join.cu", "query_p95_ms"
KERNEL, DEVICE_NAME = "range_join_mask", "range_join_mask_kernel"

# what it reads on the shared fake run of test_perfbench_metrics.py
CASE = {"reads": 50.0}


def read(run):
    t = run.timeline.get("device_s", {}).get(DEVICE_NAME) if run.timeline else None
    b = run.bound_s.get(KERNEL)
    if not t or not b:
        return None
    return 100.0 * b / t
