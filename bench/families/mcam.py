"""The MCAM family: repro_torch's MemoryStore programmed once and searched
by RetrievalEngine.search under many-class few-shot traffic, with the
inputs, the check, the control and the work counts that go with it.

A configuration (`"program": "mcam"`) gives the widths, the encoding, the
MCAM parameters, the store's rows, classes and shots, the embedding's
scale and spread, the rows a programming write takes (`program_rows`)
and, to partition the programmed store into contiguous shards
(`MemoryStore.shard`), `n_shards`. A mix gives `mode`, `batch`, `k`,
`class_skew`, and where it routes a partitioned store `nprobe` (the
shards a query visits, `SearchRequest.nprobe`); a mix that writes gives
`write_every` and `write_classes` (a write of that many new classes
before every n-th batch), one that does not leaves both out or at 0.

The inputs are drawn on the device from the seed. Every class c is one
run of `shots` consecutive positions of the write stream (positions
[c shots, (c + 1) shots)); the initial supports are the first `classes`
classes and each write appends `write_classes` more, so the ring of
`capacity` rows holds positions [P - capacity, P) after P positions. A
class's centre is N(0, centre_scale^2) in each dimension. Where the
configuration's `embedding` gives `alphabets` A, the classes fall into A
runs of consecutive classes (class c, c < classes, into c A // classes;
a written class as c mod classes), as Omniglot's characters fall into
alphabets, and a centre is centre_scale (sqrt(s) a + sqrt(1 - s) e) of
its alphabet's N(0, 1) centre a and its own e, s the `alphabet_share`:
the same spread of centres, with a store sorted by alphabet, so that
contiguous shards hold few alphabets each. A
query draws its class from the classes still whole in the ring,
uniformly where the mix's `class_skew` is 0, and else by Zipf's law of
that exponent over their ranks, newest class first; and its embedding
around that class's centre with fresh spread, so no batch of queries
repeats. The program only ever receives the tensors.

What decides `correct` is the plain reference (bench/reference/mcam.py)
computed again after the window from the same inputs. It replays the
ring write by write, so each checked batch meets the store as the
program's search met it, and routes a partitioned store with its own
router. Each number counts disagreements; the cell's file gives each its
limit:

  query_words_wrong  query words (the store's quantize_queries) that differ
  rows_wrong         candidate rows that differ: phase 1's shortlist in
                     order of (distance, row), over the visited shards'
                     rows where the mix routes; `full`: every row
  dist_wrong         candidates' ideal distances that differ
  votes_wrong        candidates' noisy votes that differ
  labels_wrong       candidates' labels that differ
  predictions_wrong  labels the window delivered to the host that differ
  store_wrong        the final store's quantised words, labels, write count
                     and calibrated range that differ
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from bench import work as yardstick
from bench.reference import mcam
from bench.trace import SEARCH_SPAN, WRITE_SPAN

NUMBERS = ("query_words_wrong", "rows_wrong", "dist_wrong", "votes_wrong",
           "labels_wrong", "predictions_wrong", "store_wrong")

#: rows of a store in a dry run (bench/run.py --dry): the fused shortlist's
#: threshold, so that a shortlist takes the main path's route; `full`,
#: which has no shortlist, at a quarter of it
DRY_ROWS = 1024


# -- the inputs ------------------------------------------------------------------


class Inputs:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % 2 ** 63)
        self.dim, self.shots = config["dim"], config["shots"]
        self.capacity = config["capacity"]
        self.scale = config["embedding"]["centre_scale"]
        self.spread = config["embedding"]["spread"]
        self.alphabets = config["embedding"].get("alphabets", 0)
        self.share = config["embedding"].get("alphabet_share", 0.0)
        self.classes = config["classes"]
        self.skew = traffic["class_skew"]
        self._zipf: tuple[int, torch.Tensor | None] = (0, None)
        # centres of the classes a query can still draw live in a ring
        self.slots = self.classes + 2 * traffic.get("write_classes", 0) + 2
        self.centres = torch.empty(self.slots, self.dim, device=self.device)
        if self.alphabets:
            self.alphabet_centres = self._randn(self.alphabets)
        self.centres[:self.classes] = self._centres(0, self.classes)
        self.next_class = self.classes

    def _randn(self, rows: int) -> torch.Tensor:
        return torch.randn(rows, self.dim, generator=self.gen,
                           device=self.device)

    def _centres(self, c0: int, c1: int) -> torch.Tensor:
        own = self._randn(c1 - c0)
        if not self.alphabets:
            return own * self.scale
        cls = torch.arange(c0, c1, device=self.device) % self.classes
        a = self.alphabet_centres[cls * self.alphabets // self.classes]
        return self.scale * (self.share ** 0.5 * a
                             + (1 - self.share) ** 0.5 * own)

    def _members(self, c0: int, c1: int) -> tuple[torch.Tensor, torch.Tensor]:
        labels = torch.arange(c0, c1, device=self.device).repeat_interleave(
            self.shots)
        x = self.centres[labels % self.slots] + self.spread * self._randn(
            labels.shape[0])
        return x, labels.to(torch.int32)

    def supports(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The initial store: every class's shots, (classes x shots, dim)
        float32 and their int32 labels."""
        return self._members(0, self.classes)

    def new_classes(self, count: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The next `count` classes: fresh centres and their shots."""
        c0, c1 = self.next_class, self.next_class + count
        idx = torch.arange(c0, c1, device=self.device) % self.slots
        self.centres[idx] = self._centres(c0, c1)
        self.next_class = c1
        return self._members(c0, c1)

    def live_classes(self) -> tuple[int, int]:
        """[first, last + 1) of the classes whose shots are all in the ring."""
        oldest = self.next_class * self.shots - self.capacity
        return max(0, -(-oldest // self.shots)), self.next_class

    def _ranks(self, n: int, batch: int) -> torch.Tensor:
        """`batch` ranks in [0, n), rank r drawn in proportion to
        (r + 1) ** -class_skew."""
        if self._zipf[0] != n:
            w = torch.arange(1, n + 1, dtype=torch.float64,
                             device=self.device) ** -self.skew
            self._zipf = (n, w)
        return torch.multinomial(self._zipf[1], batch, replacement=True,
                                 generator=self.gen)

    def queries(self, batch: int) -> torch.Tensor:
        lo, hi = self.live_classes()
        if self.skew:
            cls = hi - 1 - self._ranks(hi - lo, batch)
        else:
            cls = torch.randint(lo, hi, (batch,), generator=self.gen,
                                device=self.device)
        return self.centres[cls % self.slots] + self.spread * self._randn(batch)


# -- the program, and the reference in its place ----------------------------------


class Port:
    """repro_torch's MemoryStore (create, calibrate, write, shard) and
    RetrievalEngine.search with the configuration's search settings.
    Nothing else of the program is read but the spans, ranges and kernel
    names its calls leave in a trace."""

    def __init__(self, config: dict, device):
        from repro_torch.core.avss import SearchConfig
        from repro_torch.core.mcam import MCAMConfig
        from repro_torch.core.memory import MemoryConfig
        from repro_torch.engine import (MemoryStore, RetrievalEngine,
                                        SearchRequest)
        search = SearchConfig(encoding=config["encoding"], cl=config["cl"],
                              mode=config["mode"],
                              mcam=MCAMConfig(**config["mcam"]),
                              noisy=config["noisy"])
        self.cfg = MemoryConfig(capacity=config["capacity"],
                                dim=config["dim"], search=search,
                                clip_std=config["clip_std"])
        self.engine = RetrievalEngine(search)
        self.device = device
        self._store, self._request = MemoryStore, SearchRequest

    def create(self):
        return self._store.create(self.cfg, self.device)

    def request(self, mode: str, k: int, nprobe: int | None = None):
        return self._request(mode=mode, k=max(k, 1), nprobe=nprobe)

    def search(self, store, queries, request):
        return self.engine.search(store, queries, request)


class Control:
    """The plain reference put in the program's place, with the interface
    the family drives (create, calibrate, write, shard, search, predict):
    the control of the check, run in a lower precision than the
    configuration's, which has to come out not correct."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        self.config, self.device, self.dtype = config, device, dtype

    def create(self) -> "_ReferenceStore":
        return _ReferenceStore(mcam.Store(self.config, self.device,
                                          self.dtype))

    def request(self, mode: str, k: int, nprobe: int | None = None):
        return mode, k, nprobe

    def search(self, store: "_ReferenceStore", queries: torch.Tensor,
               request):
        mode, k, nprobe = request
        if mode == "two_phase":
            out = mcam.two_phase(queries, store.ref, k, self.dtype,
                                 route_by=_route(store.n_shards, nprobe))
        else:
            out = mcam.full(queries, store.ref,
                            torch.arange(queries.shape[0],
                                         device=queries.device), self.dtype)
        return _ReferenceResult(out)


class _ReferenceStore:
    """A reference store read and written as the program's is."""

    def __init__(self, ref: mcam.Store):
        self.ref, self.n_shards = ref, None

    def calibrate(self, sample: torch.Tensor) -> "_ReferenceStore":
        self.ref.calibrate(sample)
        return self

    def write(self, x: torch.Tensor, labels: torch.Tensor
              ) -> "_ReferenceStore":
        self.ref.write(x, labels)
        return self

    def shard(self, n_shards: int) -> "_ReferenceStore":
        self.n_shards = n_shards
        return self

    def quantize_queries(self, q: torch.Tensor) -> torch.Tensor:
        return self.ref.query_words(q)

    @property
    def values(self) -> torch.Tensor:
        return self.ref.words

    @property
    def labels(self) -> torch.Tensor:
        return self.ref.labels

    @property
    def size(self) -> torch.Tensor:
        return torch.tensor(self.ref.size)

    @property
    def lo(self) -> torch.Tensor:
        return self.ref.lo

    @property
    def hi(self) -> torch.Tensor:
        return self.ref.hi


class _ReferenceResult:
    def __init__(self, out: dict):
        self.votes, self.dist = out["votes"], out["dist"]
        self.indices, self.labels = out["rows"], out["labels"]
        self._pred = out["pred"]

    def predict(self) -> torch.Tensor:
        return self._pred


def control(config: dict, device):
    """The program the check's control runs: the reference in bfloat16,
    one precision below the configuration's float32."""
    return Control(config, device, torch.bfloat16)


def _route(n_shards: int | None, nprobe: int | None
           ) -> tuple[int, int] | None:
    return None if nprobe is None else (n_shards, nprobe)


# -- serving ---------------------------------------------------------------------


@dataclasses.dataclass
class State:
    """The program's store and what the check needs of the window: the
    supports, and the order of the inputs drawn (("q" | "w", count)): the
    check draws the writes again from the seed (`replay`), so the window
    keeps no tensor of its own on the device."""
    config: dict
    traffic: dict
    program: object
    store: object
    inputs: Inputs | None
    supports: tuple[torch.Tensor, torch.Tensor]
    request: object
    log: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    n_writes: int = 0


def setup(config: dict, traffic: dict, seed: int, device,
          program=None) -> State:
    """The inputs drawn from the seed, the store created, calibrated on
    the supports, programmed in writes of `program_rows` and, where the
    configuration gives `n_shards`, partitioned."""
    shards, nprobe = config.get("n_shards"), traffic.get("nprobe")
    if shards is not None and config["capacity"] % shards:
        raise ValueError(f"mcam: {config['capacity']} rows do not split "
                         f"into {shards} shards")
    if nprobe is not None and shards is None:
        raise ValueError("mcam: a mix that routes (nprobe) needs a "
                         "configuration that partitions (n_shards)")
    if program is None:
        program = Port(config, device)
    inputs = Inputs(config, traffic, seed, device)
    x, labels = inputs.supports()
    t_program = time.perf_counter()
    store = program.create().calibrate(x)
    step = config["program_rows"]
    for r0 in range(0, x.shape[0], step):
        store = store.write(x[r0:r0 + step], labels[r0:r0 + step])
    if shards is not None:
        store = store.shard(n_shards=shards)
    _log(f"store of {x.shape[0]} supports programmed"
         f"{'' if shards is None else f' in {shards} shards'} in "
         f"{time.perf_counter() - t_program:.3f} s")
    return State(config, traffic, program, store, inputs, (x, labels),
                 program.request(traffic["mode"], traffic["k"], nprobe))


def issue(state: State, no: int, span) -> tuple:
    """Enqueue batch `no`, the write due before it first -> (queries
    counted, the predicted labels to copy home, the tensors the check
    keeps, the writes before it)."""
    t = state.traffic
    every = t.get("write_every", 0)
    if every and no % every == every - 1:
        n = t["write_classes"]
        x, labels = state.inputs.new_classes(n)
        state.log.append(("w", n))
        state.n_writes += 1
        with span(WRITE_SPAN):
            state.store = state.store.write(x, labels)
    q = state.inputs.queries(t["batch"])
    state.log.append(("q", t["batch"]))
    with span(SEARCH_SPAN):
        res = state.program.search(state.store, q, state.request)
        pred = res.predict()
    kept = {"queries": q, "votes": res.votes, "dist": res.dist,
            "indices": res.indices, "labels": res.labels}
    return t["batch"], pred, kept, state.n_writes


def deliver(home: torch.Tensor) -> np.ndarray:
    """A batch's labels on the host, as the check keeps them."""
    return home.numpy().copy()


def replay(state: State, seed: int, device) -> list:
    """Every write of the run, drawn again from the seed in the order of
    the log; the supports drawn again must equal the run's."""
    state.inputs = None
    inputs = Inputs(state.config, state.traffic, seed, device)
    if not torch.equal(inputs.supports()[0], state.supports[0]):
        raise RuntimeError("bench: the seed did not give the same inputs "
                           "twice")
    writes = []
    for kind, n in state.log:
        if kind == "w":
            writes.append(inputs.new_classes(n))
        else:
            inputs.queries(n)
    _log(f"{len(writes)} writes in all")
    return writes


# -- the check -------------------------------------------------------------------


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(b.device, b.dtype) != b).sum())


def check(state: State, writes: list, sampled: dict, device) -> dict:
    """The numbers of the module docstring for one run. writes: every
    write after the supports (x, labels), in order; sampled: {batch no:
    (the batch's queries and results by name, delivered labels, writes
    before it)}; the program's store after the window is state.store."""
    config, traffic, store = state.config, state.traffic, state.store
    route = _route(config.get("n_shards"), traffic.get("nprobe"))
    out = dict.fromkeys(NUMBERS, 0)
    ref = mcam.Store(config, device)
    ref.calibrate(state.supports[0])
    ref.write(*state.supports)
    applied = 0
    for no in sorted(sampled):
        got, delivered, n_writes = sampled[no]
        q = got["queries"]
        while applied < n_writes:
            ref.write(*writes[applied])
            applied += 1
        with torch.no_grad():
            if traffic["mode"] == "two_phase":
                r = mcam.two_phase(q, ref, traffic["k"], route_by=route)
            else:
                r = mcam.full(q, ref, torch.arange(q.shape[0],
                                                   device=q.device))
        out["query_words_wrong"] += _diff(store.quantize_queries(q),
                                          r["words"])
        for name, have, want in (("rows_wrong", "indices", "rows"),
                                 ("dist_wrong", "dist", "dist"),
                                 ("votes_wrong", "votes", "votes"),
                                 ("labels_wrong", "labels", "labels")):
            out[name] += _diff(got[have], r[want])
        out["predictions_wrong"] += int(np.sum(
            np.asarray(delivered) != r["pred"].cpu().numpy()))
    while applied < len(writes):
        ref.write(*writes[applied])
        applied += 1
    out["store_wrong"] = (
        _diff(store.values, ref.words) + _diff(store.labels, ref.labels)
        + int(int(store.size) != ref.size)
        + int(not torch.equal(store.lo.cpu().float(), ref.lo.cpu()))
        + int(not torch.equal(store.hi.cpu().float(), ref.hi.cpu())))
    return out


# -- what routing keeps ----------------------------------------------------------


def recall(config: dict, traffic: dict, seed: int, device, nprobes: list,
           batches: int) -> dict:
    """How near a routed search comes to the exhaustive one on the cell's
    own store and queries (not timed, not part of a run): for each nprobe,
    over `batches` batches of the mix, the share of the exhaustive
    search's k rows that the routed search also returns (recall@k) and
    the share of queries whose predicted label (top-1) and best row agree
    with the exhaustive search's."""
    state = setup(config, traffic, seed, device)
    prog, store, k = state.program, state.store, traffic["k"]
    mode = traffic["mode"]
    sums = {p: [0, 0, 0] for p in nprobes}
    for _ in range(batches):
        q = state.inputs.queries(traffic["batch"])
        ex = prog.search(store, q, prog.request(mode, k, None))
        ex_pred = ex.predict()
        ex_best = torch.take_along_dim(ex.indices, ex.best()[:, None], 1)
        for p in nprobes:
            r = prog.search(store, q, prog.request(mode, k, p))
            found = (ex.indices[:, :, None] == r.indices[:, None, :]).any(2)
            best = torch.take_along_dim(r.indices, r.best()[:, None], 1)
            sums[p][0] += int(found.sum())
            sums[p][1] += int((r.predict() == ex_pred).sum())
            sums[p][2] += int((best == ex_best).sum())
    n = batches * traffic["batch"]
    return {p: {"recall_at_k": a / (n * k), "top1_label": b / n,
                "top1_row": c / n} for p, (a, b, c) in sums.items()}


# -- sizes and work --------------------------------------------------------------


def dry(config: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at a size the CPU runs in seconds: DRY_ROWS rows (the last
    class left out, so some slots stay empty), batches of 4, k <= 8, small
    writes; the widths, encoding, physics and partition are the
    configuration's."""
    rows = DRY_ROWS if traffic["mode"] != "full" else DRY_ROWS // 4
    config = dict(config, capacity=rows,
                  classes=rows // config["shots"] - 1,
                  program_rows=rows // 2)
    writes = {key: min(traffic[key], most) for key, most in
              (("write_classes", 8), ("write_every", 2)) if key in traffic}
    traffic = dict(traffic, batch=4, k=min(traffic["k"], 8), **writes)
    return config, traffic


def size(config: dict, traffic: dict) -> dict:
    """The sizes a control line names."""
    return {"rows": config["capacity"], "batch": traffic["batch"]}


def work(config: dict, traffic: dict) -> dict[str, dict]:
    """The bounds of the kernels one batch of the cell drives
    (bench/work.py). A routed shortlist ranks nprobe shards of rows a
    query and reads the distinct rows of the shards the batch can visit,
    at most every row."""
    b, n, d = traffic["batch"], config["capacity"], config["dim"]
    s, sl = yardstick.strings(config), config["mcam"]["string_len"]
    if traffic["mode"] == "full":
        return {"dense": yardstick.dense(b, n, s, sl)}
    k, visit = traffic["k"], n
    shards, nprobe = config.get("n_shards"), traffic.get("nprobe")
    if nprobe is not None and nprobe < shards:
        per = n // shards
        visit, n = nprobe * per, min(shards, b * nprobe) * per
    return {"shortlist": yardstick.shortlist(b, n, d, k, visit),
            "rescore": yardstick.rescore(b, k, s, sl)}


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
