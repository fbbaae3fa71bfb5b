"""Calibrated physical-device models (paper §IV.C, Table I).

The paper measures real phones over ADB: current, voltage, CPU%, memory, and
bandwidth, across five task stages.  No phones exist in this environment, so
the Device Simulation tier is backed by *calibrated stochastic device models*:
per-grade stage costs seeded from Table I, with log-normal jitter for
device-to-device and round-to-round variation.  The interface mirrors what
PhoneMgr's measurement loop produces, so the rest of the platform (allocation,
benchmarking-device accounting, GUI-style metric streams) is unchanged.

Two granularities:

* ``DeviceModel`` — one device, sequential NumPy ``Generator`` draws.  Used
  for telemetry streams and single-device inspection.
* ``DeviceFleet`` — the batched round engine's model: ONE vectorized NumPy
  call samples *all* devices × 5 Table-I stages per round.  Randomness is a
  counter-based hash of ``(seed, device_id, draw_counter, lane)`` so each
  device's stream is persistent across rounds (the round-to-round variation
  the docstring promises), deterministic, independent of fleet composition,
  and checkpointable by saving the per-device counters alone.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterator

import numpy as np


class Stage(enum.IntEnum):
    """Table I stages."""

    NO_APK = 1  # background cleared, APK not running
    APK_LAUNCH = 2  # APK started, training not begun
    TRAINING = 3
    POST_TRAINING = 4  # training done, APK still active
    APK_CLOSED = 5


@dataclasses.dataclass(frozen=True)
class StageCost:
    power_mah: float  # average power consumption over the stage
    duration_min: float  # average stage duration (minutes)
    comm_kb: float = 0.0  # communication volume (training stage only)


# Table I of the paper, verbatim (High / Low grade, five stages).
TABLE1: dict[str, dict[Stage, StageCost]] = {
    "High": {
        Stage.NO_APK: StageCost(0.24, 0.25),
        Stage.APK_LAUNCH: StageCost(0.51, 0.25),
        Stage.TRAINING: StageCost(0.18, 0.27, 33.10),
        Stage.POST_TRAINING: StageCost(0.37, 0.25),
        Stage.APK_CLOSED: StageCost(0.44, 0.25),
    },
    "Low": {
        Stage.NO_APK: StageCost(1.71, 0.25),
        Stage.APK_LAUNCH: StageCost(1.80, 0.25),
        Stage.TRAINING: StageCost(0.66, 0.36, 33.10),
        Stage.POST_TRAINING: StageCost(1.65, 0.25),
        Stage.APK_CLOSED: StageCost(1.82, 0.25),
    },
}


@dataclasses.dataclass(frozen=True)
class DeviceGrade:
    """A device performance class (paper: High/Low; extensible by model,
    CPU frequency, NPU support...)."""

    name: str
    cpu_cores: int
    memory_gb: float
    # Relative compute throughput (FLOP/s) used to scale training duration
    # with model cost; High-grade phones in Table I are ~0.27/0.36 = 0.75x
    # the Low-grade training time.
    rel_flops: float = 1.0
    stage_costs: dict[Stage, StageCost] = dataclasses.field(default_factory=dict)

    def cost(self, stage: Stage) -> StageCost:
        if stage in self.stage_costs:
            return self.stage_costs[stage]
        base = TABLE1["High" if self.rel_flops >= 1.0 else "Low"]
        return base[stage]


HIGH = DeviceGrade("High", cpu_cores=4, memory_gb=12.0, rel_flops=1.0,
                   stage_costs=TABLE1["High"])
LOW = DeviceGrade("Low", cpu_cores=1, memory_gb=6.0, rel_flops=0.75,
                  stage_costs=TABLE1["Low"])
GRADES = {"High": HIGH, "Low": LOW}


@dataclasses.dataclass(frozen=True)
class MetricSample:
    """One PhoneMgr telemetry sample (paper §IV.C retrieval set)."""

    t: float
    stage: Stage
    current_ua: float
    voltage_mv: float
    cpu_pct: float
    mem_kb: float
    bandwidth_b: float


@dataclasses.dataclass(frozen=True)
class RoundReport:
    """Per-round, per-stage outcome for one simulated physical device."""

    device_id: int
    grade: str
    round_idx: int
    stage_power_mah: dict[Stage, float]
    stage_duration_min: dict[Stage, float]
    comm_kb: float

    @property
    def total_duration_min(self) -> float:
        return sum(self.stage_duration_min.values())

    @property
    def total_power_mah(self) -> float:
        return sum(self.stage_power_mah.values())


class DeviceModel:
    """Stochastic emulation of one benchmarking device."""

    def __init__(self, device_id: int, grade: DeviceGrade, *, seed: int = 0,
                 jitter: float = 0.08):
        self.device_id = device_id
        self.grade = grade
        self.jitter = jitter
        self.rng = np.random.default_rng(seed ^ (device_id * 0x51ED2705))

    def _noisy(self, mean: float) -> float:
        if mean == 0.0:
            return 0.0
        sigma = math.sqrt(math.log(1.0 + self.jitter**2))
        return float(mean * self.rng.lognormal(-0.5 * sigma**2, sigma))

    def run_round(self, round_idx: int, *, train_cost_scale: float = 1.0
                  ) -> RoundReport:
        """Simulate the five Table-I stages of one training round.

        ``train_cost_scale`` scales the TRAINING stage with the model's
        computational cost (relative to the paper's LR/Avazu workload).
        """
        powers, durs, comm = {}, {}, 0.0
        for stage in Stage:
            c = self.grade.cost(stage)
            scale = train_cost_scale if stage == Stage.TRAINING else 1.0
            powers[stage] = self._noisy(c.power_mah * scale)
            durs[stage] = self._noisy(c.duration_min * scale)
            if stage == Stage.TRAINING:
                comm = self._noisy(c.comm_kb)
        return RoundReport(
            device_id=self.device_id,
            grade=self.grade.name,
            round_idx=round_idx,
            stage_power_mah=powers,
            stage_duration_min=durs,
            comm_kb=comm,
        )

    def telemetry(self, report: RoundReport, hz: float = 1.0) -> Iterator[MetricSample]:
        """Emit PhoneMgr-style samples over the round (for the metrics DB)."""
        t = 0.0
        voltage_mv = 3950.0
        for stage in Stage:
            dur_s = report.stage_duration_min[stage] * 60.0
            n = max(1, int(dur_s * hz))
            # Convert stage mAh over duration to average current in uA.
            dur_h = max(report.stage_duration_min[stage] / 60.0, 1e-9)
            cur_ua = report.stage_power_mah[stage] / dur_h * 1000.0
            cpu = {Stage.TRAINING: 90.0, Stage.APK_LAUNCH: 35.0}.get(stage, 5.0)
            mem = 2.2e5 if stage in (Stage.APK_LAUNCH, Stage.TRAINING,
                                     Stage.POST_TRAINING) else 4.0e4
            bw = report.comm_kb * 1024.0 / n if stage == Stage.TRAINING else 0.0
            for i in range(n):
                yield MetricSample(
                    t=t + (i + 1) / hz,
                    stage=stage,
                    current_ua=self._noisy(cur_ua),
                    voltage_mv=self._noisy(voltage_mv),
                    cpu_pct=min(100.0, self._noisy(cpu)),
                    mem_kb=self._noisy(mem),
                    bandwidth_b=bw,
                )
            t += dur_s


# --------------------------------------------------------------------------- #
# Vectorized fleet model (batched round engine)
# --------------------------------------------------------------------------- #

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 wrap-around is intentional)."""
    with np.errstate(over="ignore"):
        z = x + _SM_GAMMA
        z = (z ^ (z >> np.uint64(30))) * _SM_M1
        z = (z ^ (z >> np.uint64(27))) * _SM_M2
        return z ^ (z >> np.uint64(31))


def _counter_normals(seed: int, device_ids: np.ndarray, counters: np.ndarray,
                     n_lanes: int) -> np.ndarray:
    """Standard normals of shape ``(n_devices, n_lanes)`` from a stateless
    hash of (seed, device_id, per-device counter, lane) via Box–Muller."""
    dev = device_ids.astype(np.uint64)[:, None]
    ctr = counters.astype(np.uint64)[:, None]
    lane = np.arange(2 * n_lanes, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        base = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                           ^ dev * np.uint64(0x51ED2705))
        base = _splitmix64(base ^ ctr * np.uint64(0xD1B54A32D192ED03))
        h = _splitmix64(base ^ lane * np.uint64(0x8CB92BA72F3D8DD7))
    # (0, 1) uniforms from the top 53 bits; +0.5 keeps u strictly positive.
    u = ((h >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0**-53
    u1, u2 = u[:, :n_lanes], u[:, n_lanes:]
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@dataclasses.dataclass(frozen=True)
class FleetRoundSample:
    """One vectorized round of Table-I samples for a whole device cohort.

    Arrays are indexed ``[device, stage]`` with stages in ``list(Stage)``
    order; ``device_ids[i]`` names the device behind row ``i``.
    """

    device_ids: np.ndarray  # (n,) int
    round_idx: int
    grade: str
    stage_power_mah: np.ndarray  # (n, num_stages)
    stage_duration_min: np.ndarray  # (n, num_stages)
    comm_kb: np.ndarray  # (n,)

    @property
    def total_duration_min(self) -> np.ndarray:
        return self.stage_duration_min.sum(axis=1)

    @property
    def total_power_mah(self) -> np.ndarray:
        return self.stage_power_mah.sum(axis=1)

    def arrival_offsets_s(self) -> np.ndarray:
        """Per-device round completion offsets in seconds — the arrival-time
        contract consumed by DeviceFlow (message ``created_t`` stamps)."""
        return self.total_duration_min * 60.0

    def stage_duration_s(self, stage: Stage) -> np.ndarray:
        """Per-device duration of one Table-I stage in seconds (the
        measurement feed of ``calibration.RuntimeCalibrator``)."""
        return self.stage_duration_min[:, list(Stage).index(stage)] * 60.0

    def report(self, i: int) -> RoundReport:
        """Materialize row ``i`` as a classic per-device ``RoundReport``."""
        stages = list(Stage)
        return RoundReport(
            device_id=int(self.device_ids[i]),
            grade=self.grade,
            round_idx=self.round_idx,
            stage_power_mah={s: float(self.stage_power_mah[i, j])
                             for j, s in enumerate(stages)},
            stage_duration_min={s: float(self.stage_duration_min[i, j])
                                for j, s in enumerate(stages)},
            comm_kb=float(self.comm_kb[i]),
        )


class DeviceFleet:
    """Vectorized stochastic model of a whole device cohort of one grade.

    Owns persistent per-device RNG state (a draw counter per device): calling
    ``run_round`` twice yields *different* jittered samples per device, and a
    checkpointed fleet resumes its streams exactly.
    """

    def __init__(self, grade: DeviceGrade, num_devices: int, *, seed: int = 0,
                 jitter: float = 0.08, first_device_id: int = 0):
        if num_devices < 0:
            raise ValueError("num_devices must be non-negative")
        self.grade = grade
        self.seed = seed
        self.jitter = jitter
        self._first_id = first_device_id
        self.device_ids = np.arange(
            first_device_id, first_device_id + num_devices, dtype=np.int64)
        self._counters = np.zeros(num_devices, dtype=np.int64)
        stages = list(Stage)
        self._mean_power = np.array(
            [grade.cost(s).power_mah for s in stages])
        self._mean_dur = np.array(
            [grade.cost(s).duration_min for s in stages])
        self._mean_comm = float(grade.cost(Stage.TRAINING).comm_kb)
        self._train_col = stages.index(Stage.TRAINING)

    def __len__(self) -> int:
        return len(self.device_ids)

    def grow(self, num_devices: int) -> None:
        """Extend the fleet to ``num_devices`` devices (contiguous ids).

        Existing devices keep their draw counters; new ones start fresh —
        safe because each device's stream depends only on its own id/counter,
        never on fleet composition.
        """
        extra = num_devices - len(self.device_ids)
        if extra <= 0:
            return
        self.device_ids = np.arange(
            self._first_id, self._first_id + num_devices, dtype=np.int64)
        self._counters = np.concatenate(
            [self._counters, np.zeros(extra, dtype=np.int64)])

    def rows_for(self, device_ids: np.ndarray) -> np.ndarray:
        """Map device ids to fleet row indices (grows the fleet if needed)."""
        ids = np.asarray(device_ids, dtype=np.int64)
        if ids.size and int(ids.max()) >= self._first_id + len(self.device_ids):
            self.grow(int(ids.max()) - self._first_id + 1)
        return ids - self._first_id

    def run_round(self, round_idx: int, *, train_cost_scale: float = 1.0,
                  rows: np.ndarray | None = None) -> FleetRoundSample:
        """Sample all devices (or the ``rows`` subset) × 5 stages at once."""
        rows = np.arange(len(self.device_ids)) if rows is None else np.asarray(rows)
        ids = self.device_ids[rows]
        n_stages = len(self._mean_power)
        normals = _counter_normals(
            self.seed, ids, self._counters[rows], 2 * n_stages + 1)
        self._counters[rows] += 1
        sigma = math.sqrt(math.log(1.0 + self.jitter**2))
        jit = np.exp(-0.5 * sigma**2 + sigma * normals)  # mean-preserving
        scale = np.ones(n_stages)
        scale[self._train_col] = train_cost_scale
        power = self._mean_power * scale * jit[:, :n_stages]
        dur = self._mean_dur * scale * jit[:, n_stages:2 * n_stages]
        comm = self._mean_comm * jit[:, 2 * n_stages]
        # _noisy semantics: zero-mean costs stay exactly zero.
        power[:, self._mean_power == 0.0] = 0.0
        dur[:, self._mean_dur == 0.0] = 0.0
        if self._mean_comm == 0.0:
            comm = np.zeros_like(comm)
        return FleetRoundSample(
            device_ids=ids, round_idx=round_idx, grade=self.grade.name,
            stage_power_mah=power, stage_duration_min=dur, comm_kb=comm)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict:
        return {"counters": self._counters.copy(), "seed": self.seed,
                "jitter": self.jitter, "device_ids": self.device_ids.copy()}

    def load_state_dict(self, d: dict) -> None:
        """Adopt the saved fleet layout wholesale — restoring into a freshly
        constructed (possibly empty, lazily-grown) fleet must work."""
        counters = np.asarray(d["counters"], dtype=np.int64)
        ids = np.asarray(d["device_ids"], dtype=np.int64)
        if counters.shape != ids.shape:
            raise ValueError("corrupt fleet state_dict: counters/ids mismatch")
        if "seed" in d and d["seed"] != self.seed:
            raise ValueError(
                f"fleet seed mismatch: checkpoint {d['seed']} vs {self.seed} "
                "— restored streams would diverge")
        self.device_ids = ids.copy()
        self._counters = counters.copy()
        self.jitter = float(d.get("jitter", self.jitter))
        if len(ids):
            self._first_id = int(ids[0])


def training_duration_s(grade: DeviceGrade, *, train_cost_scale: float = 1.0) -> float:
    """Deterministic mean round duration (beta_i input to the allocator)."""
    return grade.cost(Stage.TRAINING).duration_min * 60.0 * train_cost_scale


def startup_duration_s(grade: DeviceGrade) -> float:
    """Mean framework startup time (lambda_i input to the allocator)."""
    return grade.cost(Stage.APK_LAUNCH).duration_min * 60.0
