"""driver.sync_wait_share.solo: percent of the host time of the
program's top-level spans (``costs.build``, ``solve``, ``solution.*``)
that the host spent blocked in the device->host reads counted inside
them (their ``sync_wait_s``), over the spans the program recorded in the
traced part of the window (``repro_torch.obs.tracing.recorded()``; a
retrace after lost records only adds calls). None when it recorded no
``solve`` span, as a program without the recorder does."""

TOP = ("costs.build", "solve")


def top_level(spans):
    """The front-door spans of the ring: no parent, a top-level name."""
    return [s for s in spans if s.get("parent_id") is None
            and (s["name"] in TOP or s["name"].startswith("solution."))]


def recorded():
    """The program's recorded spans, or [] without a recorder."""
    try:
        from repro_torch.obs import tracing
        return list(tracing.recorded())
    except (ImportError, AttributeError):
        return []


def read(w):
    top = top_level(recorded())
    host_s = sum(s["dur_s"] for s in top)
    if not any(s["name"] == "solve" for s in top) or host_s <= 0:
        return None
    wait_s = sum(sum(s.get("sync_wait_s", {}).values()) for s in top)
    return 100.0 * wait_s / host_s
