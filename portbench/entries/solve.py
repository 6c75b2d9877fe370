"""Entry ``solve``: a closed loop of calls to the port's front door.

Each call builds the costs of its instances with
``repro_torch.core.costs.build_cost_matrix`` (one launch: a 2-D call
for one instance, a batched one for several), hands them to
``repro_torch.core.api.solve`` under the default ``DispatchPolicy``
and fetches the declared artifacts to the host, which is where the user
reads them. The next call starts when the previous one has returned. An
assignment call hands the front door one pre-batched bucket,
``{"c": c}``; an OT call a list of ``(c, nu, mu)`` instances.

Workload keys: ``want``, ``warmup_calls``, ``trace_seconds``.
"""
from __future__ import annotations

import os

import numpy as np


def _host_answers(sols, problem: str):
    """Each instance's answer as host arrays, in the reference's terms."""
    out = []
    for s in sols:
        y_b, y_a = s.duals()
        a = {"cost": float(s.cost), "y_b": y_b, "y_a": y_a}
        if problem == "assignment":
            a["matching"] = s.matching()
        else:
            p = s.plan_sparse()
            a.update(rows=p.rows, cols=p.cols, vals=p.vals)
        out.append(a)
    return out


class _Caller:
    """One call of the loop, with the program's modules bound once."""

    def __init__(self, env):
        from repro_torch.core import api
        from repro_torch.core import costs

        cfg, params = env.cell.config, env.cell.params
        self.env, self.api, self.costs = env, api, costs
        self.problem = cfg["problem"]
        self.spec = api.ASSIGNMENT if self.problem == "assignment" else api.OT
        self.policy = api.DispatchPolicy()
        self.want = tuple(params["want"])
        self.metric, self.eps = cfg["metric"], float(cfg["eps"])

    def __call__(self, call, rounds: bool):
        dev, insts = self.env.device, call.instances
        if len(insts) == 1:
            c = self.costs.build_cost_matrix(insts[0].x, insts[0].y,
                                             self.metric, device=dev)[None]
        else:
            c = self.costs.build_cost_matrix(
                np.stack([i.x for i in insts]), np.stack([i.y for i in insts]),
                self.metric, device=dev)
        if self.problem == "assignment":
            sols = list(self.api.solve(self.spec, {"c": c}, self.eps,
                                       self.policy, want=self.want,
                                       device=dev))
        else:
            items = [(c[j], i.nu, i.mu) for j, i in enumerate(insts)]
            sols = self.api.solve(self.spec, items, self.eps, self.policy,
                                  want=self.want, device=dev)
        del c
        answers = _host_answers(sols, self.problem)
        occ = []
        for st in {id(s.stats): s.stats for s in sols}.values():
            occ.extend(st.occupancy)
        rnd = [int(s.rounds) for s in sols] if rounds else []
        return answers, occ, rnd


def run(env):
    from repro_torch.core import device as rdev
    from repro_torch.kernels import ops

    from portbench.lib.harness import Window
    from portbench.lib.trace import Tracer, lost_records

    params = env.cell.params
    caller = _Caller(env)
    if env.device.type == "cuda":
        ops.build_kernels()
    pool = env.calls
    warm = int(params.get("warmup_calls", 1))
    for k in range(warm):
        caller(pool[k % len(pool)], rounds=False)
    env.sync()
    w = Window()
    tracer = Tracer(env.torch, env.device) if env.trace else None
    trace_s = float(params.get("trace_seconds", 5.0))
    syncs0 = dict(rdev.sync_counts)
    setup_peak = env.peak()
    env.reset_peak()
    cpu0 = os.times()
    t0 = env.clock()
    w.setup_s = t0 - env.t_start
    metric = env.cell.config["metric"]

    def traced_call(call):
        with tracer.call_span():
            out = caller(call, rounds=True)
        m, n = call.instances[0].shape
        w.traced_calls += 1
        w.traced_shapes.append((metric, len(call.instances), m, n,
                                call.instances[0].x.shape[1]))
        return out

    i = warm
    durations = []
    while env.clock() - t0 < env.seconds:
        t_call = env.clock()
        call = pool[i % len(pool)]
        i += 1
        b = len(call.instances)
        w.attempted += b
        traced = tracer is not None and (
            tracer.started or env.clock() - t0 >= env.seconds - trace_s)
        if traced and not tracer.started:
            tracer.start()
        try:
            answers, occ, rnd = (traced_call(call) if traced
                                 else caller(call, rounds=env.trace))
        except Exception as e:           # counted and reported; no answer
            w.notes.setdefault("errors", []).append(repr(e)[:300])
            continue
        durations.append(env.clock() - t_call)
        w.calls_done += 1
        w.instances_done += b
        w.occupancy.extend(occ)
        w.rounds.extend(rnd)
        w.answers.extend(zip(call.instances, answers))
    env.sync()
    w.elapsed_s = env.clock() - t0
    cpu1 = os.times()
    w.notes["host_cpu_s"] = {"user": cpu1.user - cpu0.user,
                             "system": cpu1.system - cpu0.system}
    w.peak_bytes = env.peak()
    w.process_peak_bytes = max(setup_peak, w.peak_bytes)
    w.sync_delta = {k: v - syncs0.get(k, 0)
                    for k, v in rdev.sync_counts.items()}
    if durations:
        d, half = np.asarray(durations), len(durations) // 2
        w.notes["call_s"] = {
            "p10": float(np.percentile(d, 10)),
            "p50": float(np.percentile(d, 50)),
            "p90": float(np.percentile(d, 90)),
            "halves": [float(d[:max(half, 1)].mean()), float(d[half:].mean())]}
    if tracer is not None:
        if not tracer.started:
            tracer.start()
        tracer.stop()
        if lost_records(tracer.summary):
            # trace the same calls again, after the window, in a new
            # session
            w.notes["trace_lost"] = [tracer.summary.launches,
                                     tracer.summary.host_launches]
            tracer = Tracer(env.torch, env.device)
            w.traced_calls = 0
            w.traced_shapes = []
            tracer.start()
            t1 = env.clock()
            while w.traced_calls == 0 or env.clock() - t1 < trace_s:
                traced_call(pool[i % len(pool)])
                i += 1
            tracer.stop()
        w.trace = tracer.summary
        w.notes["tracer_host_s"] = tracer.host_s
        w.notes["trace_launches"] = {"device": tracer.summary.launches,
                                     "host": tracer.summary.host_launches}
    del caller
    if env.device.type == "cuda":
        env.torch.cuda.empty_cache()
    return w
