"""DianaGridRuntime: the paper's meta-scheduler over a pod fleet.

Pods are sites (RootGrids); work items (training jobs / bulk inference
groups) are scheduled with the §IV/§V cost model, §VIII bulk splitting
and §IX migration. Straggler mitigation is literal C6: a degraded pod
(capacity drop reported by its heartbeat) sees its *queued* work
migrate to cheaper peers; running steps are never recalled
(non-preemptive). Elastic scale: pods join/leave via the C7 topology.

The same decisions as ``repro.grid.runtime``, over the port's core: a
pod's costs are host Python scalars (a fleet has a handful of pods), and
its queue is the port's ``MultilevelFeedbackQueues``, which
re-prioritizes on the host as the reference's does. Nothing here touches
a device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from ..core import (
    CostWeights, GridTopology, Job, MultilevelFeedbackQueues, NetworkLink, Node, PeerView,
    select_peer,
)
from ..core.migration import apply_migration
from .capacity import PodCapacity

__all__ = ["WorkItem", "PodHandle", "DianaGridRuntime"]

_wid = itertools.count()


@dataclass
class WorkItem:
    """One schedulable unit at grid level."""

    user: str
    arch: str
    shape: str
    steps: int = 1                      # train steps or decode batches
    data_bytes: float = 0.0             # checkpoint/dataset to move if cold
    resident_pod: Optional[str] = None  # where its data already lives
    wid: int = field(default_factory=lambda: next(_wid))
    group_id: Optional[str] = None
    # runtime
    pod: Optional[str] = None
    migrated: bool = False
    finished: bool = False


class PodHandle:
    """A pod's control-plane face: queue + health + capacity."""

    def __init__(self, capacity: PodCapacity, quotas: Optional[dict] = None):
        self.capacity = capacity
        self.queue: list[WorkItem] = []
        self.mlfq = MultilevelFeedbackQueues(quotas=quotas or {})
        self._jobs: dict[int, WorkItem] = {}
        self.healthy = True
        self.degraded_factor = 1.0      # <1 ⇒ straggler

    @property
    def name(self) -> str:
        return self.capacity.name

    def effective_flops(self) -> float:
        return self.capacity.flops * self.degraded_factor * (1.0 if self.healthy else 0.0)

    def work_seconds(self, item: WorkItem) -> float:
        base = self.capacity.step_cost(item.arch, item.shape)
        if base <= 0:
            base = 1.0 / max(self.capacity.chips, 1)
        return item.steps * base / max(self.degraded_factor, 1e-6)

    def queued_seconds(self) -> float:
        return sum(self.work_seconds(w) for w in self.queue)

    def enqueue(self, item: WorkItem, now: float = 0.0) -> Job:
        job = Job(user=item.user, t=1.0, submit_time=now,
                  compute_work=self.work_seconds(item),
                  input_bytes=item.data_bytes, group_id=item.group_id)
        job.job_id = item.wid
        self._jobs[item.wid] = item
        self.queue.append(item)
        self.mlfq.submit(job, now=now)
        item.pod = self.name
        return job

    def dequeue_next(self, now: float = 0.0) -> Optional[WorkItem]:
        job = self.mlfq.pop_next(now=now)
        if job is None:
            return None
        item = self._jobs.pop(job.job_id)
        self.queue.remove(item)
        return item

    def remove(self, item: WorkItem):
        self.queue.remove(item)
        for j in list(self.mlfq.jobs):
            if j.job_id == item.wid:
                self.mlfq.remove(j)
                break
        self._jobs.pop(item.wid, None)


class DianaGridRuntime:
    """The fleet-level DIANA meta-scheduler (one logical RootGrid peerset)."""

    def __init__(self, pods: list[PodCapacity],
                 dcn_links: Optional[dict[tuple[str, str], NetworkLink]] = None,
                 quotas: Optional[dict[str, float]] = None,
                 weights: CostWeights = CostWeights(w_queue=0.0, w_work=1.0, w_load=0.0)):
        self.pods = {p.name: PodHandle(p, quotas) for p in pods}
        self.links = dcn_links or {}
        self.weights = weights
        self.topology = GridTopology()
        for p in pods:
            self.topology.join(p.name, Node(name=f"{p.name}-coord", capacity=p.chips))

    # -- link model ------------------------------------------------------------
    def link(self, a: str, b: str) -> NetworkLink:
        if a == b:
            return NetworkLink(bandwidth_Bps=1e12)      # resident: free
        return self.links.get(
            (a, b), NetworkLink(bandwidth_Bps=self.pods[b].capacity.dcn_bandwidth_Bps,
                                loss_rate=self.pods[b].capacity.dcn_loss_rate,
                                rtt_s=self.pods[b].capacity.dcn_rtt_s))

    # -- §IV cost of placing item on pod ---------------------------------------
    def placement_cost(self, item: WorkItem, pod_name: str) -> float:
        pod = self.pods[pod_name]
        if not pod.healthy:
            return float("inf")
        src = item.resident_pod or pod_name
        lk = self.link(src, pod_name)
        net = lk.loss_rate / lk.bandwidth_Bps * 1e6
        comp = pod.queued_seconds() + pod.work_seconds(item)
        dtc = (item.data_bytes / lk.effective_bandwidth()) if src != pod_name else 0.0
        return net + comp + dtc

    # -- §V single placement ----------------------------------------------------
    def schedule(self, item: WorkItem, now: float = 0.0) -> str:
        ranked = sorted(self.pods, key=lambda n: self.placement_cost(item, n))
        for name in ranked:
            if self.pods[name].healthy:
                self.pods[name].enqueue(item, now)
                return name
        raise RuntimeError("no healthy pod")

    # -- §VIII bulk -------------------------------------------------------------
    def schedule_bulk(self, items: list[WorkItem], now: float = 0.0,
                      division_factor: int = 1) -> dict[str, list[WorkItem]]:
        """A bulk submission is one group; split into ≤division_factor
        subgroups across pods proportional to effective capacity."""
        gid = items[0].group_id or f"g{items[0].wid}"
        for it in items:
            it.group_id = gid
        if division_factor <= 1:
            pod = min(self.pods, key=lambda n: sum(
                self.placement_cost(it, n) for it in items))
            for it in items:
                self.pods[pod].enqueue(it, now)
            return {pod: items}
        caps = {n: p.effective_flops() for n, p in self.pods.items() if p.healthy}
        k = min(division_factor, len(caps))
        chosen = sorted(caps, key=lambda n: -caps[n])[:k]
        total = sum(caps[n] for n in chosen)
        out: dict[str, list[WorkItem]] = {n: [] for n in chosen}
        cursor = 0
        for i, n in enumerate(chosen):
            take = round(len(items) * caps[n] / total) if i < len(chosen) - 1 \
                else len(items) - cursor
            for it in items[cursor : cursor + take]:
                self.pods[n].enqueue(it, now)
                out[n].append(it)
            cursor += take
        return out

    # -- §IX migration / straggler mitigation -----------------------------------
    def mitigate_stragglers(self, now: float = 0.0, max_moves: int = 16) -> list[tuple[WorkItem, str]]:
        """Queued work leaves degraded/overloaded pods for cheaper peers."""
        moved: list[tuple[WorkItem, str]] = []
        for name, pod in self.pods.items():
            if pod.degraded_factor >= 1.0 and len(pod.mlfq) < 2 * pod.capacity.chips:
                continue
            for job in list(pod.mlfq.low_priority_jobs()) or [
                j for j in pod.mlfq.jobs if pod.degraded_factor < 1.0
            ]:
                if len(moved) >= max_moves:
                    return moved
                item = pod._jobs.get(job.job_id)
                if item is None:
                    continue
                peers = [
                    PeerView(name=p, queue_length=len(h.mlfq),
                             jobs_ahead=h.mlfq.jobs_ahead(job.priority),
                             total_cost=self.placement_cost(item, p),
                             alive=h.healthy)
                    for p, h in self.pods.items() if p != name
                ]
                decision = select_peer(job, name, pod.mlfq.jobs_ahead(job.priority),
                                       self.placement_cost(item, name), peers)
                if decision.migrate and decision.target:
                    pod.remove(item)
                    apply_migration(job, decision)
                    item.migrated = True
                    self.pods[decision.target].enqueue(item, now)
                    moved.append((item, decision.target))
        return moved

    # -- elasticity ---------------------------------------------------------------
    def pod_failed(self, name: str, now: float = 0.0) -> list[WorkItem]:
        """Pod loss: requeue its work elsewhere (restoring a job from its
        checkpoint is the job's own concern)."""
        pod = self.pods[name]
        pod.healthy = False
        orphans = list(pod.queue)
        for it in orphans:
            pod.remove(it)
            it.migrated = True
            self.schedule(it, now)
        self.topology.fail_site_master(name)
        return orphans

    def pod_joined(self, capacity: PodCapacity, quotas: Optional[dict] = None):
        self.pods[capacity.name] = PodHandle(capacity, quotas)
        self.topology.join(capacity.name,
                           Node(name=f"{capacity.name}-coord", capacity=capacity.chips))

    def set_degraded(self, name: str, factor: float):
        self.pods[name].degraded_factor = factor
