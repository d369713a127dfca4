"""Cluster graph representation (paper §3 "Data Representation").

Nodes are machines with features {region, compute capability, total GPU
memory}; edges carry measured communication latency in **ms per 64-byte
message** (paper Table 1). The adjacency matrix stores latencies; 0 means
"cannot communicate" (network-policy blocked) and the diagonal is 0.

Feature versions
----------------
``node_features(version=...)`` supports two schemas:

* **v1** (default) — ``[one-hot region | capability/10 | memory/512]``,
  the paper's static machine description. Every pre-existing checkpoint
  was trained on this layout.
* **v2** — v1 plus three *runtime-observable* columns threaded back from
  the simulator (``sim.evaluate.observed_telemetry``): the persistent
  straggler slowdown multiplier, the per-op jitter sigma, and relay-hub
  membership (the node forwards traffic for policy-blocked pairs). A
  graph with no ``telemetry`` attached emits the clean-fleet defaults
  (slowdown 1, sigma 0, not a hub), so v2 features of an unobserved
  fleet degrade gracefully to "v1 plus zeros".

``version_for_dim`` maps a model's input width back to its feature
version — the shim that lets old (v1) checkpoints and new (v2) ones
coexist: inference derives the feature layout from the loaded params
instead of assuming the current default (see ``core.train.predict``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Regions and the paper's measured latency rows (Table 1, ms per 64 bytes).
# ---------------------------------------------------------------------------
REGIONS = [
    "Beijing", "Nanjing", "California", "Tokyo", "Berlin",
    "London", "NewDelhi", "Paris", "Rome", "Brasilia",
]
_R = {r: i for i, r in enumerate(REGIONS)}

# np.nan marks "unreachable" (Beijing<->Paris in the paper).
_T1_COLS = ["California", "Tokyo", "Berlin", "London", "NewDelhi", "Paris", "Rome", "Brasilia"]
PAPER_LATENCY_TABLE = {
    "Beijing":    [89.1, 74.3, 250.5, 229.8, 341.9, np.nan, 296.0, 341.8],
    "Nanjing":    [97.9, 173.8, 213.7, 176.7, 236.3, 265.1, 741.3, 351.3],
    "California": [1.0, 118.8, 144.8, 132.3, 197.0, 133.9, 158.6, 158.6],
}

# Rough great-circle distances (1000 km) used ONLY to complete pairs the paper
# does not report; latency estimate = 0.7 ms per 100 km (fiber RTT-ish) + 20ms.
_COORDS = {  # lat, lon
    "Beijing": (39.9, 116.4), "Nanjing": (32.1, 118.8), "California": (37.4, -122.1),
    "Tokyo": (35.7, 139.7), "Berlin": (52.5, 13.4), "London": (51.5, -0.1),
    "NewDelhi": (28.6, 77.2), "Paris": (48.9, 2.4), "Rome": (41.9, 12.5),
    "Brasilia": (-15.8, -47.9),
}


def _haversine_km(a: str, b: str) -> float:
    lat1, lon1 = np.radians(_COORDS[a])
    lat2, lon2 = np.radians(_COORDS[b])
    dlat, dlon = lat2 - lat1, lon2 - lon1
    h = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * 6371.0 * np.arcsin(np.sqrt(h))


def region_latency_ms(a: str, b: str) -> float:
    """Latency (ms / 64B msg) between regions: paper value if measured, else
    a distance-derived estimate. Returns np.nan for blocked pairs."""
    if a == b:
        return 1.0
    for src, dst in ((a, b), (b, a)):
        if src in PAPER_LATENCY_TABLE and dst in _T1_COLS:
            return PAPER_LATENCY_TABLE[src][_T1_COLS.index(dst)]
    return 20.0 + 0.7 * _haversine_km(a, b) / 100.0 * 10.0


# ---------------------------------------------------------------------------
# GPU catalog: name -> (compute capability, mem GB/GPU, bf16-ish TFLOP/s/GPU)
# (capability is the paper's "computing power" feature; TFLOP/s feeds the
#  cost model).
# ---------------------------------------------------------------------------
GPU_CATALOG = {
    "A100":     (8.0, 80, 312.0),
    "A40":      (8.6, 48, 149.7),
    "V100":     (7.0, 32, 125.0),
    "A5000":    (8.6, 24, 111.1),
    "GTX1080Ti": (6.1, 11, 11.3),
    "RTX3090":  (8.6, 24, 71.0),
    "TITANXp":  (6.1, 12, 12.1),
}


@dataclasses.dataclass
class Machine:
    """A fleet node. Capability/memory/tflops normally derive from the GPU
    catalog; nodes that are not catalog GPUs (TPU pods, custom hosts) carry
    explicit values via the ``*_override`` fields or ``Machine.from_caps``."""
    region: str
    gpu: str
    n_gpus: int = 8
    capability_override: float | None = None
    memory_gb_override: float | None = None
    tflops_override: float | None = None

    @classmethod
    def from_caps(cls, region: str, capability: float, memory_gb: float,
                  tflops: float, label: str = "custom") -> "Machine":
        """A machine described by its capabilities instead of a GPU model."""
        return cls(region, label, n_gpus=1, capability_override=capability,
                   memory_gb_override=memory_gb, tflops_override=tflops)

    @property
    def capability(self) -> float:
        if self.capability_override is not None:
            return self.capability_override
        return GPU_CATALOG[self.gpu][0]

    @property
    def memory_gb(self) -> float:
        if self.memory_gb_override is not None:
            return self.memory_gb_override
        return GPU_CATALOG[self.gpu][1] * self.n_gpus

    @property
    def tflops(self) -> float:
        if self.tflops_override is not None:
            return self.tflops_override
        return GPU_CATALOG[self.gpu][2] * self.n_gpus


# ---------------------------------------------------------------------------
# Node telemetry: runtime-observable per-machine signals (feature version 2).
# ---------------------------------------------------------------------------
# v2 normalization: slowdown multipliers are O(1..4) (3x stragglers are the
# stress case), so (slowdown - 1) / SLOWDOWN_SCALE lands in O(0..1).
SLOWDOWN_SCALE = 4.0
FEATURE_VERSIONS = (1, 2)


@dataclasses.dataclass(frozen=True)
class NodeTelemetry:
    """Observed per-machine runtime signals, exported from the simulator
    (``sim.compute.ComputeModel.telemetry`` + ``sim.network`` relay hubs)
    and attached to a ``ClusterGraph`` for v2 node features."""
    slowdown: np.ndarray      # (n,) persistent multiplier, 1.0 = healthy
    jitter_sigma: np.ndarray  # (n,) lognormal sigma of per-op jitter
    relay_hub: np.ndarray     # (n,) 1.0 if the node relays blocked pairs

    @classmethod
    def clean(cls, n: int) -> "NodeTelemetry":
        """The unobserved default: healthy, jitter-free, no relaying."""
        return cls(np.ones(n, np.float32), np.zeros(n, np.float32),
                   np.zeros(n, np.float32))

    def subset(self, ids: Sequence[int]) -> "NodeTelemetry":
        ids = list(ids)
        return NodeTelemetry(self.slowdown[ids].copy(),
                             self.jitter_sigma[ids].copy(),
                             self.relay_hub[ids].copy())

    def with_load(self, load: Sequence[float]) -> "NodeTelemetry":
        """Fold a colocated tenant's per-machine utilization (0..1, clipped
        at 0.95) into the observed slowdown: a machine whose capacity is 60%
        claimed by another workload looks 2.5x slower to the labeler, the
        same capacity-share stretch a fair scheduler would produce. This is
        how the training labeler 'sees' serve load (and vice versa) on a
        shared fleet."""
        load = np.clip(np.asarray(load, np.float32), 0.0, 0.95)
        if len(load) != len(self.slowdown):
            raise ValueError(f"load has {len(load)} entries for "
                             f"{len(self.slowdown)} machines")
        return NodeTelemetry(self.slowdown / (1.0 - load),
                             self.jitter_sigma.copy(),
                             self.relay_hub.copy())

    def extended(self, k: int = 1) -> "NodeTelemetry":
        """Telemetry for a fleet that grew by ``k`` (joined machines start
        with clean signals — nothing has been observed about them yet)."""
        c = NodeTelemetry.clean(k)
        return NodeTelemetry(np.append(self.slowdown, c.slowdown),
                             np.append(self.jitter_sigma, c.jitter_sigma),
                             np.append(self.relay_hub, c.relay_hub))


def feature_dim(version: int) -> int:
    """Node-feature width of a schema version (see module docstring)."""
    base = len(REGIONS) + 2
    if version == 1:
        return base
    if version == 2:
        return base + 3
    raise ValueError(f"unknown feature version {version}")


def version_for_dim(d_in: int) -> int:
    """Invert ``feature_dim`` — the checkpoint-compat shim: a loaded model's
    input width tells us which feature schema it was trained on."""
    for v in FEATURE_VERSIONS:
        if feature_dim(v) == d_in:
            return v
    raise ValueError(f"no feature version has dimension {d_in}; "
                     f"known: { {v: feature_dim(v) for v in FEATURE_VERSIONS} }")


@dataclasses.dataclass
class ClusterGraph:
    """Dense graph of machines. latency[i, j] in ms/64B; 0 = no edge.
    ``telemetry`` (optional) carries observed runtime signals for v2
    features; structural ops (subgraph/add/remove) keep it aligned."""
    machines: list[Machine]
    latency: np.ndarray  # (n, n) float, 0 on diagonal and blocked pairs
    telemetry: NodeTelemetry | None = None

    @property
    def n(self) -> int:
        return len(self.machines)

    def with_telemetry(self, telemetry: NodeTelemetry | None) -> "ClusterGraph":
        """Same fleet, new observed signals (None detaches them)."""
        return ClusterGraph(self.machines, self.latency, telemetry)

    def node_features(self, version: int = 1) -> np.ndarray:
        """Per-node feature matrix (paper §3: v_0 = {'Beijing', 8.6, 152}
        embedded into vector space). v1 is the static machine description;
        v2 appends the observed telemetry columns (module docstring)."""
        n_r = len(REGIONS)
        feats = np.zeros((self.n, feature_dim(version)), np.float32)
        for i, m in enumerate(self.machines):
            feats[i, _R[m.region]] = 1.0
            feats[i, n_r] = m.capability / 10.0
            feats[i, n_r + 1] = m.memory_gb / 512.0
        if version >= 2:
            tel = self.telemetry or NodeTelemetry.clean(self.n)
            feats[:, n_r + 2] = (tel.slowdown - 1.0) / SLOWDOWN_SCALE
            feats[:, n_r + 3] = tel.jitter_sigma
            feats[:, n_r + 4] = tel.relay_hub
        return feats

    def adjacency_mask(self) -> np.ndarray:
        a = (self.latency > 0).astype(np.float32)
        np.fill_diagonal(a, 0.0)
        return a

    def memory_gb(self) -> np.ndarray:
        return np.array([m.memory_gb for m in self.machines], np.float32)

    def tflops(self) -> np.ndarray:
        return np.array([m.tflops for m in self.machines], np.float32)

    # -- scalability (paper §5.2) ------------------------------------------
    def add_machine(self, machine: Machine,
                    latencies: dict[int, float] | None = None) -> "ClusterGraph":
        """Join a machine: define {City, Capability, Memory} and connect it with
        latency-weighted edges (region-derived if not given)."""
        n = self.n
        lat = np.zeros((n + 1, n + 1), self.latency.dtype)
        lat[:n, :n] = self.latency
        for j, other in enumerate(self.machines):
            if latencies is not None and j in latencies:
                w = latencies[j]
            else:
                w = region_latency_ms(machine.region, other.region)
            if np.isnan(w):
                w = 0.0
            lat[n, j] = lat[j, n] = w
        tel = self.telemetry.extended() if self.telemetry is not None else None
        return ClusterGraph(self.machines + [machine], lat, tel)

    def remove_machines(self, ids: Sequence[int]) -> "ClusterGraph":
        """Scalability/disaster recovery: drop nodes (remove edge info)."""
        keep = [i for i in range(self.n) if i not in set(ids)]
        return self.subgraph(keep)

    def subgraph(self, ids: Sequence[int]) -> "ClusterGraph":
        ids = list(ids)
        tel = self.telemetry.subset(ids) if self.telemetry is not None else None
        return ClusterGraph([self.machines[i] for i in ids],
                            self.latency[np.ix_(ids, ids)].copy(), tel)


def _latency_matrix(machines: list[Machine], rng: np.random.Generator) -> np.ndarray:
    n = len(machines)
    lat = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in range(i + 1, n):
            base = region_latency_ms(machines[i].region, machines[j].region)
            if np.isnan(base):
                continue  # blocked pair -> no edge
            jitter = float(rng.uniform(0.9, 1.1))
            lat[i, j] = lat[j, i] = base * jitter
    return lat


def paper_fig1_graph(seed: int = 0) -> ClusterGraph:
    """The 8-machine example of Fig. 1 (node 0 = {Beijing, 8.6, 152})."""
    rng = np.random.default_rng(seed)
    machines = [
        Machine("Beijing", "RTX3090", 6),     # cap 8.6, ~152GB total w/ mixed
        Machine("California", "A100", 8),
        Machine("Tokyo", "V100", 8),
        Machine("London", "A40", 8),
        Machine("Nanjing", "A5000", 8),
        Machine("Berlin", "RTX3090", 8),
        Machine("NewDelhi", "GTX1080Ti", 8),
        Machine("Rome", "TITANXp", 8),
    ]
    return ClusterGraph(machines, _latency_matrix(machines, rng))


def paper_fleet46(seed: int = 0) -> ClusterGraph:
    """The 46-server / 368-GPU fleet of §6.1 (8 GPUs per server, mixed models
    across the paper's regions). The exact fleet is private; this is a seeded
    reconstruction with the published latency rows."""
    rng = np.random.default_rng(seed)
    gpus = list(GPU_CATALOG)
    machines = []
    for i in range(46):
        region = REGIONS[int(rng.integers(0, len(REGIONS)))]
        gpu = gpus[int(rng.integers(0, len(gpus)))]
        machines.append(Machine(region, gpu, 8))
    return ClusterGraph(machines, _latency_matrix(machines, rng))


def random_fleet(n: int, seed: int = 0) -> ClusterGraph:
    rng = np.random.default_rng(seed)
    gpus = list(GPU_CATALOG)
    machines = [Machine(REGIONS[int(rng.integers(0, len(REGIONS)))],
                        gpus[int(rng.integers(0, len(gpus)))],
                        int(rng.integers(4, 9)))
                for _ in range(n)]
    return ClusterGraph(machines, _latency_matrix(machines, rng))
