"""``k3_roofline``: the best-match kernel's share of its roofline in the
traced window: the least time of every launch (:func:`portbench.count.k3.k3_bound_s`
at the launch's images, its grid's third dimension, the server's query
budget, the frame's pixels and the descriptor dimension) over the launches'
device time."""

from portbench.count.k3 import k3_bound_s


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    net = record["config"]["dense_correspondence_network"]
    hw = net["image_height"] * net["image_width"]
    launches = [(d, grid) for name, _, d, grid in trace["kernels"] if "best_match" in name]
    if not launches or any(len(grid) != 3 for _, grid in launches):
        return None
    bound = sum(k3_bound_s(int(grid[2]), record["queries"], net["descriptor_dimension"], hw)[0]
                for _, grid in launches)
    return 100.0 * bound / (sum(d for d, _ in launches) * 1e-6)
