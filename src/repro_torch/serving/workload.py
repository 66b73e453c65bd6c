"""Serving workloads: the paper's three datasets (Table 2) + arrivals.

Each dataset is summarized by its latency SLOs and the P25/P50/P75
(input, output) token lengths; samplers draw from a lognormal fitted
through those percentiles, or run in fixed-size mode (the paper truncates
prompts to a fixed size per experiment so results are comparable).

SLO classes: GreenLLM's carbon headroom comes from exploiting *per-
application* latency slack (Table 2: a chatbot turn needs 200 ms TTFT, a
summarization job tolerates 15 s). `SLOClass` makes that slack a first-
class request attribute: every `Request` carries an `slo_class`
(tight / standard / relaxed), each class scaling the dataset's base
TTFT/TPOT targets and mapping to a scheduler priority
(serving/batching.py admits, composes, and preempts by it; the fleet
dispatcher and the allocator gate per-class). "standard" has scale 1.0 -
a single-class workload is bit-identical to the pre-class code paths.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.distributed.fault import FaultEvent, FaultTrace

Z75 = 0.6744897501960817  # Phi^-1(0.75)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency class: a scheduler priority + SLO scale factors + a
    provisioning load target.

    `priority` orders admission/preemption (0 = most latency-critical);
    the scales multiply the *dataset's* Table-2 targets, so a class means
    the same thing relative to every workload ("tight" chat is 100 ms
    TTFT, "tight" summarization 7.5 s). `utilization` is the per-instance
    load target the allocator provisions this class's traffic at: the
    0.6 default exists to absorb Poisson queueing into tail TTFT, and a
    class with TTFT slack can spend that slack on queueing instead of
    idle headroom - running its instances hotter is exactly where the
    per-class carbon headroom lives (EcoServe)."""

    name: str
    priority: int
    ttft_scale: float
    tpot_scale: float
    utilization: float = 0.6

    def targets(self, ds: "Dataset") -> tuple[float, float]:
        return ds.ttft_slo_s * self.ttft_scale, ds.tpot_slo_s * self.tpot_scale


SLO_CLASSES = {
    # standard is the identity class: scale 1.0, the allocator's stock
    # 0.6 load target - single-class code paths are bit-identical
    "tight": SLOClass("tight", 0, ttft_scale=0.5, tpot_scale=0.75,
                      utilization=0.5),
    "standard": SLOClass("standard", 1, ttft_scale=1.0, tpot_scale=1.0,
                         utilization=0.6),
    "relaxed": SLOClass("relaxed", 2, ttft_scale=5.0, tpot_scale=2.0,
                        utilization=0.9),
}
NUM_PRIORITIES = 1 + max(c.priority for c in SLO_CLASSES.values())

# the mixed-class traffic shape the priority benchmarks serve (a latency-
# critical minority over a bulk of standard turns plus batchy background)
DEFAULT_CLASS_MIX = {"tight": 0.25, "standard": 0.5, "relaxed": 0.25}


def class_priority(slo_class: str) -> int:
    """Scheduler priority of a class name (0 = highest)."""
    return SLO_CLASSES[slo_class].priority


def slo_targets(ds: "Dataset", slo_class: str) -> tuple[float, float]:
    """(TTFT, TPOT) targets of `slo_class` on dataset `ds` (Table 2 base)."""
    return SLO_CLASSES[slo_class].targets(ds)


@dataclasses.dataclass(frozen=True)
class Dataset:
    name: str
    task: str
    ttft_slo_s: float
    tpot_slo_s: float
    p25: tuple[int, int]
    p50: tuple[int, int]
    p75: tuple[int, int]
    # class newly sampled requests default to when no `class_mix` is given
    # ("standard" = the dataset's own Table-2 targets, scale 1.0)
    slo_class: str = "standard"

    def size_at(self, percentile: str) -> tuple[int, int]:
        return {"p25": self.p25, "p50": self.p50, "p75": self.p75}[percentile]


DATASETS = {
    "sharegpt": Dataset("sharegpt", "chatbot", 0.200, 0.080, (24, 24), (160, 140), (510, 357)),
    "humaneval": Dataset("humaneval", "code-completion", 0.125, 0.200, (108, 31), (136, 55), (182, 88)),
    "longbench": Dataset("longbench", "summarization", 15.0, 0.150, (1134, 201), (1495, 275), (1817, 352)),
}


@dataclasses.dataclass(frozen=True)
class Request:
    """One arrival. The session fields describe PREFIX-SHARING structure
    for the cross-request KV cache (serving/prefix_cache.py):

    session_id       turns of one conversation share it; each turn's
                     prompt is the previous turn's prompt + its output +
                     the new user message, so consecutive turns share a
                     growing block-aligned prefix. None (the default) =
                     a one-shot request sharing nothing.
    prefix_group     cross-session shared SYSTEM prompt id: requests of
                     one group open with the same `prefix_share_len`
                     tokens (an agent fleet's common scaffold).
    prefix_share_len length of that shared opening, in tokens.

    All three default to "no sharing", so existing workloads (and their
    sampled rng streams) are untouched."""

    req_id: int
    arrival_s: float
    prompt_len: int
    output_len: int
    slo_class: str = "standard"
    session_id: Optional[int] = None
    prefix_group: Optional[int] = None
    prefix_share_len: int = 0
    # Lifecycle bounds (both absolute times; None = unbounded, the default,
    # which leaves every legacy schedule bit-identical):
    #   deadline_s   the request must FINISH by this time or it times out;
    #                a relaxed-class request with a deadline is a
    #                run-anytime-before-T job the planner may defer.
    #   cancel_at_s  client cancellation - the request is aborted at the
    #                first scheduling point at/after this time.
    deadline_s: Optional[float] = None
    cancel_at_s: Optional[float] = None

    def __post_init__(self):
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(f"unknown slo_class: {self.slo_class!r} "
                             f"(one of {sorted(SLO_CLASSES)})")
        if self.prefix_share_len < 0:
            raise ValueError(
                f"negative prefix_share_len: {self.prefix_share_len}")
        if self.prefix_group is not None and self.prefix_share_len == 0:
            raise ValueError("prefix_group set but prefix_share_len is 0")
        if self.deadline_s is not None and self.deadline_s <= self.arrival_s:
            raise ValueError(
                f"deadline_s {self.deadline_s} must exceed arrival_s")
        if self.cancel_at_s is not None and self.cancel_at_s < self.arrival_s:
            raise ValueError(
                f"cancel_at_s {self.cancel_at_s} precedes arrival_s")

    @property
    def priority(self) -> int:
        return class_priority(self.slo_class)


def _lognormal_params(p25: float, p50: float, p75: float) -> tuple[float, float]:
    mu = math.log(max(p50, 1.0))
    sigma = math.log(max(p75, 1.0) / max(p25, 1.0)) / (2.0 * Z75)
    return mu, max(sigma, 1e-3)


def _class_fn(dataset: Dataset,
              class_mix: Optional[dict[str, float]],
              seed: int) -> Callable[[np.random.Generator], str]:
    """Per-request class sampler off a DEDICATED rng stream: adding or
    changing `class_mix` never perturbs the arrival/size stream of the
    same seed, so a mixed-class run is the SAME physical workload as its
    classless twin with priorities overlaid (the controlled comparison
    the priority benchmarks make). `class_mix=None` assigns the dataset's
    default class."""
    if class_mix is None:
        default = dataset.slo_class
        if default not in SLO_CLASSES:
            raise ValueError(f"unknown dataset slo_class: {default!r}")
        return lambda _rng: default
    unknown = set(class_mix) - set(SLO_CLASSES)
    if unknown:
        raise ValueError(f"unknown slo classes in mix: {sorted(unknown)}")
    if min(class_mix.values(), default=-1) < 0 or sum(class_mix.values()) <= 0:
        raise ValueError(f"bad class mix: {class_mix}")
    names = sorted(class_mix)
    p = np.asarray([class_mix[n] for n in names], dtype=float)
    p /= p.sum()
    crng = np.random.default_rng((seed, 0x51_0C1A55))  # class-only stream
    return lambda _rng: names[crng.choice(len(names), p=p)]


def _poisson_requests(rng: np.random.Generator, qps: float, duration_s: float,
                      size_fn, cls_fn=None) -> list[Request]:
    """Shared arrival process: exponential gaps, sizes from `size_fn(rng)`."""
    reqs: list[Request] = []
    t = 0.0
    i = 0
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= duration_s:
            break
        pl, ol = size_fn(rng)
        cls = "standard" if cls_fn is None else cls_fn(rng)
        reqs.append(Request(i, t, pl, ol, slo_class=cls))
        i += 1
    return reqs


def sample_requests(
    dataset: Dataset,
    qps: float,
    duration_s: float,
    seed: int = 0,
    fixed_size: Optional[tuple[int, int]] = None,
    class_mix: Optional[dict[str, float]] = None,
) -> list[Request]:
    """Poisson arrivals at `qps` for `duration_s`; sizes lognormal or fixed.

    `class_mix` ({class: weight}) samples each request's `slo_class` from
    the mix; None assigns the dataset's default class (and leaves the rng
    stream untouched, so legacy streams are bit-identical)."""
    rng = np.random.default_rng(seed)
    if fixed_size is not None:
        size_fn = lambda _rng: fixed_size  # noqa: E731
    else:
        mu_in, sg_in = _lognormal_params(dataset.p25[0], dataset.p50[0], dataset.p75[0])
        mu_out, sg_out = _lognormal_params(dataset.p25[1], dataset.p50[1], dataset.p75[1])

        def size_fn(r):
            return (int(np.clip(r.lognormal(mu_in, sg_in), 1, 8192)),
                    int(np.clip(r.lognormal(mu_out, sg_out), 1, 4096)))
    return _poisson_requests(rng, qps, duration_s, size_fn,
                             _class_fn(dataset, class_mix, seed))


def sample_session_requests(
    dataset: Dataset,
    session_qps: float,
    duration_s: float,
    seed: int = 0,
    turns: int = 4,
    think_s: float = 8.0,
    system_len: int = 256,
    num_system_prompts: int = 1,
    class_mix: Optional[dict[str, float]] = None,
    max_prompt: int = 8192,
) -> list[Request]:
    """Multi-turn session traces - the prefix-cache workload (ROADMAP
    item 5's session model).

    Sessions (conversations / agent loops) arrive Poisson at
    `session_qps`. A session opens with one of `num_system_prompts`
    shared system prompts (`system_len` tokens - its `prefix_group`,
    shared ACROSS sessions) and runs ~`turns` turns (Poisson-distributed
    count, min 1). Turn t's prompt is the full conversation so far:

        prompt_t = prompt_{t-1} + output_{t-1} + user_t

    so consecutive turns share a strictly growing prefix (the
    within-session reuse the cache converts into skipped prefill), with
    per-turn user/output sizes lognormal-fitted to the dataset's Table-2
    percentiles. Turn t+1 arrives an exponential(`think_s`) think time
    after turn t. A session's turns share its `session_id` and SLO class.

    Sampling runs on a DEDICATED rng stream (like `_class_fn`): session
    workloads never perturb `sample_requests` streams of the same seed.
    Requests are returned arrival-sorted with sequential `req_id`s.
    Prompt growth caps at `max_prompt`: a session whose next turn would
    exceed it ends early."""
    if session_qps <= 0 or duration_s <= 0:
        raise ValueError(f"bad session stream: {session_qps=} {duration_s=}")
    if turns < 1 or think_s < 0 or system_len < 0 or num_system_prompts < 1:
        raise ValueError(
            f"bad session shape: {turns=} {think_s=} {system_len=}")
    rng = np.random.default_rng((seed, 0x5E5510))   # session-only stream
    cls_fn = _class_fn(dataset, class_mix, seed)
    mu_in, sg_in = _lognormal_params(*(p[0] for p in
                                       (dataset.p25, dataset.p50, dataset.p75)))
    mu_out, sg_out = _lognormal_params(*(p[1] for p in
                                         (dataset.p25, dataset.p50, dataset.p75)))
    reqs: list[Request] = []
    t = 0.0
    session = 0
    while True:
        t += rng.exponential(1.0 / session_qps)
        if t >= duration_s:
            break
        group = int(rng.integers(num_system_prompts))
        n_turns = max(1, 1 + rng.poisson(turns - 1))
        cls = cls_fn(rng)
        arrival = t
        prompt = system_len + int(np.clip(rng.lognormal(mu_in, sg_in), 1, 4096))
        for _ in range(n_turns):
            out = int(np.clip(rng.lognormal(mu_out, sg_out), 1, 4096))
            reqs.append(Request(
                0, arrival, prompt, out, slo_class=cls, session_id=session,
                prefix_group=group if system_len else None,
                prefix_share_len=system_len))
            arrival += rng.exponential(think_s)
            prompt += out + int(np.clip(rng.lognormal(mu_in, sg_in), 1, 4096))
            if prompt > max_prompt:
                break
        session += 1
    reqs.sort(key=lambda r: r.arrival_s)
    return [dataclasses.replace(r, req_id=i) for i, r in enumerate(reqs)]


def sample_mixture_requests(
    dataset: Dataset,
    qps: float,
    duration_s: float,
    seed: int = 0,
    weights: tuple[float, float, float] = (0.25, 0.5, 0.25),
    class_mix: Optional[dict[str, float]] = None,
) -> list[Request]:
    """Poisson arrivals whose sizes are a 3-point mixture of the dataset's
    P25/P50/P75 (input, output) pairs.

    The size-aware fleet benchmarks need heterogeneous-but-bounded request
    sizes: the lognormal sampler's open tail produces prompts no config can
    serve under tight TTFT SLOs, while a single fixed size makes bucketed
    routing trivial. The percentile mixture keeps every request inside the
    allocator's profiled bucket grid."""
    if len(weights) != 3 or min(weights) < 0 or sum(weights) <= 0:
        raise ValueError(f"bad mixture weights: {weights}")
    p = np.asarray(weights, dtype=float) / sum(weights)
    sizes = (dataset.p25, dataset.p50, dataset.p75)
    return _poisson_requests(np.random.default_rng(seed), qps, duration_s,
                             lambda r: sizes[r.choice(3, p=p)],
                             _class_fn(dataset, class_mix, seed))


def sample_piecewise_requests(
    dataset: Dataset,
    qps_profile: "list[tuple[float, float]]",
    duration_s: float,
    seed: int = 0,
    weights: tuple[float, float, float] = (0.25, 0.5, 0.25),
    class_mix: Optional[dict[str, float]] = None,
) -> list[Request]:
    """Poisson arrivals whose rate follows a piecewise-constant profile.

    `qps_profile` is [(t_start_s, qps), ...] with increasing starts from 0
    (last segment extends to `duration_s`); sizes are the same percentile
    mixture as `sample_mixture_requests`. This is the autoscaling
    workload: diurnal load swings over a diurnal grid - a static fleet
    must hold the peak allocation through every trough."""
    if not qps_profile or qps_profile[0][0] != 0.0:
        raise ValueError(f"qps_profile must start at t=0: {qps_profile}")
    starts = [t for t, _ in qps_profile]
    if any(b <= a for a, b in zip(starts, starts[1:])):
        raise ValueError(f"qps_profile starts must increase: {starts}")
    if any(q < 0 for _, q in qps_profile):
        raise ValueError(f"negative qps in profile: {qps_profile}")
    if len(weights) != 3 or min(weights) < 0 or sum(weights) <= 0:
        raise ValueError(f"bad mixture weights: {weights}")
    p = np.asarray(weights, dtype=float) / sum(weights)
    sizes = (dataset.p25, dataset.p50, dataset.p75)
    cls_fn = _class_fn(dataset, class_mix, seed)
    rng = np.random.default_rng(seed)
    reqs: list[Request] = []
    i = 0
    for k, (t0, qps) in enumerate(qps_profile):
        t1 = qps_profile[k + 1][0] if k + 1 < len(qps_profile) else duration_s
        t1 = min(t1, duration_s)
        if qps <= 0 or t1 <= t0:
            continue
        t = t0
        while True:
            t += rng.exponential(1.0 / qps)
            if t >= t1:
                break
            pl, ol = sizes[rng.choice(3, p=p)]
            reqs.append(Request(i, t, pl, ol, slo_class=cls_fn(rng)))
            i += 1
    return reqs


def sample_fault_trace(
    duration_s: float,
    num_replicas: int,
    seed: int = 0,
    kill_rate_per_hour: float = 0.0,
    preempt_rate_per_hour: float = 0.0,
    stall_rate_per_hour: float = 0.0,
    notice_s: float = 30.0,
    stall_window_s: float = 20.0,
    p_straggle: float = 0.25,
) -> FaultTrace:
    """Poisson fault arrivals per kind, each striking a uniform replica.

    Runs on a DEDICATED rng stream (the `_class_fn`/session pattern):
    overlaying a fault trace never perturbs the arrival/size/class streams
    of the same seed, so a chaos run is the SAME physical workload as its
    fault-free twin - the controlled comparison the chaos benchmarks and
    the zero-fault replay test rely on."""
    if duration_s <= 0 or num_replicas < 1:
        raise ValueError(f"bad fault trace shape: {duration_s=} {num_replicas=}")
    rng = np.random.default_rng((seed, 0xFA_017))  # fault-only stream
    events: list[FaultEvent] = []
    for kind, rate in (("kill", kill_rate_per_hour),
                       ("preempt", preempt_rate_per_hour),
                       ("stall", stall_rate_per_hour)):
        if rate <= 0:
            continue
        lam = rate / 3600.0
        t = 0.0
        while True:
            t += rng.exponential(1.0 / lam)
            if t >= duration_s:
                break
            rep = int(rng.integers(num_replicas))
            if kind == "kill":
                events.append(FaultEvent(t, "kill", replica=rep))
            elif kind == "preempt":
                events.append(FaultEvent(t, "preempt", replica=rep,
                                         notice_s=notice_s))
            else:
                events.append(FaultEvent(t, "stall", replica=rep,
                                         duration_s=stall_window_s,
                                         p_straggle=p_straggle))
    return FaultTrace(tuple(events))


def with_cancellations(
    requests: list[Request],
    seed: int = 0,
    cancel_frac: float = 0.0,
    deadline_frac: float = 0.0,
    cancel_after_s: tuple[float, float] = (0.5, 30.0),
    deadline_slack_s: tuple[float, float] = (10.0, 120.0),
    deadline_classes: tuple[str, ...] = ("relaxed",),
) -> list[Request]:
    """Overlay cancellation / deadline lifecycles on a sampled workload.

    A `cancel_frac` of requests gains `cancel_at_s` = arrival + U(range);
    a `deadline_frac` of requests whose class is in `deadline_classes`
    gains `deadline_s` = arrival + U(range) (run-anytime-before-T jobs).
    Dedicated rng stream; zero fractions return the input list unchanged."""
    if not (0.0 <= cancel_frac <= 1.0 and 0.0 <= deadline_frac <= 1.0):
        raise ValueError(f"bad fractions: {cancel_frac=} {deadline_frac=}")
    if cancel_frac == 0.0 and deadline_frac == 0.0:
        return list(requests)
    rng = np.random.default_rng((seed, 0xCA_2CE1))  # lifecycle-only stream
    out: list[Request] = []
    for r in requests:
        cancel = r.cancel_at_s
        deadline = r.deadline_s
        if cancel_frac > 0 and rng.random() < cancel_frac:
            cancel = r.arrival_s + rng.uniform(*cancel_after_s)
        elif (deadline_frac > 0 and r.slo_class in deadline_classes
              and rng.random() < deadline_frac):
            deadline = r.arrival_s + rng.uniform(*deadline_slack_s)
        if cancel is not r.cancel_at_s or deadline is not r.deadline_s:
            r = dataclasses.replace(r, cancel_at_s=cancel, deadline_s=deadline)
        out.append(r)
    return out
