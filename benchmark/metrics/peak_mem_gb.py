"""The device memory the job needs: the CUDA caching allocator's peak
(``torch.cuda.max_memory_allocated``) over the program's set-up and the
window, read by the benchmark before the reference runs; 1e9 bytes a GB."""

UNIT = "GB"
BETTER = "lower"
SOURCE = "device_trace"


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
