"""Device bytes the partition holds, per directed edge: the allocator's
``memory_allocated`` after the warm solves (every stream the cell's solves
upload) less the amount before them, over the graph's directed edges."""


def read(t):
    if t["device_bytes_upload"] is None:
        return None
    return t["device_bytes_upload"] / t["num_edges"]
