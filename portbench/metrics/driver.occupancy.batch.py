"""driver.occupancy.batch: live lanes over bucket width, summed over
every chunk of the window's solves (SolveStats.occupancy), percent."""


def read(w):
    width = sum(bb for bb, _ in w.occupancy)
    return 100.0 * sum(live for _, live in w.occupancy) / width if width else None
