"""moe.router_unmatched.train: percent of the push-relabel router's units
(k T a call) that its phase budget left unmatched, to the argmax
fallback: the ``moe.router.unmatched`` over the ``moe.router.units``
counts of the ``train.step`` spans the program recorded in the window,
forward and recompute calls alike (``repro_torch.obs.tracing``). None
when it recorded none."""


def read(w):
    from repro_torch.obs.tracing import recorded

    counts = [s.get("moe", {}) for s in recorded()
              if s["name"] == "train.step"]
    units = sum(c.get("router.units", 0) for c in counts)
    if not units:
        return None
    return 100.0 * sum(c.get("router.unmatched", 0) for c in counts) / units
