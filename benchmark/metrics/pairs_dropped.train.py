"""(Gaussian, pixel-tile) pairs that the render budgets dropped, summed over
the traced micro-steps: the train step's own ``overflow`` stat (binning
overflow plus the per-tile cap, every render of the micro-step).  A dropped
pair's gradient is lost."""


def read(r):
    return r.get("pairs_dropped")
