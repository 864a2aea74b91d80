"""What the train-step cells share: the weights made from the seed, the steps that set-up
drives through the timed call and the reference follows, the window's step, and the
comparison that decides ``correct``.

Set-up builds the program's train step once, drives it through ``CHECK_STEPS`` steps on
rows that all differ (through the window's own call and feed) and hands that same object
to the window. It keeps what the comparison reads: the weights it made, the inputs of
those steps (the segment ids the program's sampler drew, the draws), the program's
losses, its first gradient as the optimizer got it (AdamW's first moment after one
update, divided by 1 - b1) and its weights after the steps. After the window the plain
reference (benchmarks/reference) follows the same steps in float32 and the cell
compares, by the worst leaf, the gap between the program's norm and the reference's,
over the larger of the reference leaf's norm and the median leaf's:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first gradient's norm, leaf by leaf;
- ``change``: the norm of each leaf's change over the steps, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (their moves are
  round-off under Adam's normalisation);
and whatever the driver adds (``extra_checks``). The limits are in the traffic file.
"""

from __future__ import annotations

import statistics
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch

from reference.models import param_specs, make_weights
from reference.optim import AdamW

CHECK_STEPS = 3
LEAF_FLOOR = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys: Optional[List[str]] = None) -> Tuple[float, str]:
    """max over leaves of |prog - ref| / max(ref, median of ref), and its leaf."""
    keys = list(ref) if keys is None else keys
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, at = g, k
    return worst, at


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


class Result:
    """One side's readings of the check steps: each step's loss, the first gradient's
    leaf norms and the leaf norms of the weights' change."""

    def __init__(self, losses: List[float], grad: Dict[str, float],
                 change: Dict[str, float]) -> None:
        self.losses, self.grad, self.change = losses, grad, change


def compare(prog: Result, ref: Result, leaves: Optional[dict] = None) -> Dict[str, float]:
    """The numbers compared; ``leaves``, where given, gets the worst leaf of each."""
    med = statistics.median(ref.grad.values())
    keep = [k for k, v in ref.grad.items() if v >= LEAF_FLOOR * med]
    grad, g_at = leaf_gap(prog.grad, ref.grad)
    change, c_at = leaf_gap(prog.change, ref.change, keep)
    if leaves is not None:
        top = sorted(ref.grad, key=lambda k: -abs(prog.grad[k] - ref.grad[k])
                     / max(ref.grad[k], med, 1e-30))[:5]
        leaves.update(grad=g_at, change=c_at, median_grad=med,
                      top_grad=[[k, prog.grad[k], ref.grad[k]] for k in top])
    return {
        "loss": max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog.losses, ref.losses)),
        "grad": grad,
        "change": change,
    }


class TrainCell:
    """A train-step cell. A driver subclasses it and gives:
    ``model`` (the weights' model name for ``param_specs``), ``model_cfg`` (its section of
    the configuration), ``opt_cfg`` (lr, weight_decay, eps, max_grad_norm,
    lr_warmup_steps), ``build_program(W)`` -> the trained nn.Module (its state made),
    ``program_step(record)`` -> one step through the timed call (with ``record``, the dict
    of what the reference needs), ``reference_loss(ctx, W, rec, rows, fault)`` -> the
    loss of rows ``rows`` of a recorded step in the reference, as their share of the
    batch's loss, and optionally ``extra_checks(recs)`` -> {name: value}."""

    model: str
    units_per_step: float

    def __init__(self, env) -> None:
        self.env, self.dev = env, env.device
        self.cfg, self.traffic = env.config, env.traffic
        self.parts = env.parts
        self.fault: Optional[str] = None
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(env.seed % (2 ** 63))
        with self.parts("weights"):
            self.specs = param_specs(self.model, self.model_cfg)
            self.W0 = make_weights(self.specs, self.gen, self.dev)
            self.trained = [k for k, s in self.specs.items() if s[1] != "buffer"]

    # -- the program ------------------------------------------------------------

    def plant(self, fault: str) -> None:
        """Break the timed path underneath (tests): ``unchanged`` (the update leaves
        the weights as they are), ``half_batch`` (half the rows left out, the mean over
        the rest), ``altered`` (an input altered where the program produces it)."""
        self.fault = fault
        if fault == "unchanged":
            opt = self.state.opt_state
            opt.step = lambda *a, **k: None

    def warm_up(self) -> None:
        """The check steps: every shape the window uses, through the window's call."""
        with self.parts("warm_up"):
            net = self.net
            self.recs = []
            opt = self.state.opt_state
            for i in range(CHECK_STEPS):
                self.recs.append(self.program_step(record=True))
                if i == 0:  # no state where the update never ran
                    self.g1 = {n: opt.state[p]["exp_avg"].detach().clone() / 0.1
                               if p in opt.state else torch.zeros_like(p)
                               for n, p in net.named_parameters()}
            self.w_after = {n: p.detach().clone() for n, p in net.named_parameters()}
            # the window's own bookkeeping, run once here so that its kernels are loaded
            self.nonfinite = torch.zeros((), dtype=torch.int64, device=self.dev)
            self.count_nonfinite(self.recs[-1]["loss"])
            self.nonfinite.zero_()

    def step(self, spans: Dict[str, float]) -> None:
        self.program_step(record=False, spans=spans)

    def count_nonfinite(self, loss: torch.Tensor) -> None:
        self.nonfinite += (~torch.isfinite(loss)).to(torch.int64)

    def failed_steps(self) -> int:
        return int(self.nonfinite)

    def counters(self) -> Dict[str, float]:
        return {}

    def release(self) -> None:
        """Drop the program's state; keep what the comparison reads, on the host where it
        is small."""
        self.prog = Result([float(r["loss"]) for r in self.recs], norms(self.g1),
                           norms({k: self.w_after[k] - self.W0[k] for k in self.w_after}))
        self.prog_outputs = [r.get("outputs", {}) for r in self.recs]
        for name in ("state", "net", "fn", "w_after", "g1", "program"):
            if hasattr(self, name):
                delattr(self, name)

    # -- the reference ------------------------------------------------------------

    @contextmanager
    def exact(self):
        """float32 products without TF32, for the reference."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def reference(self, precision: str = "f32", fault: Optional[str] = None) -> Result:
        """The reference's readings of the check steps, the gradient summed over blocks
        of ``ref_rows`` rows."""
        from reference.models import Ctx

        o = self.opt_cfg
        opt = AdamW(o["lr"], o["weight_decay"], o["eps"], o["max_grad_norm"],
                    o["lr_warmup_steps"])
        W = dict(self.W0)
        losses, g1 = [], None
        ctx = Ctx(precision=precision)
        with self.exact():
            for rec in self.recs:
                params = {k: W[k].detach().clone().requires_grad_(True) for k in self.trained}
                Wg = {**W, **params}
                total = 0.0
                b = rec["batch_size"]
                step_rows = int(self.traffic.get("ref_rows", b))
                for r0 in range(0, b, step_rows):
                    rows = slice(r0, min(b, r0 + step_rows))
                    loss = self.reference_loss(ctx, Wg, rec, rows, fault)
                    loss.backward()
                    total += float(loss.detach())
                grads = {k: p.grad for k, p in params.items()}
                grads = opt.clip(grads)
                if g1 is None:
                    g1 = grads
                W = {**W, **{k: v.detach() for k, v in opt.step(
                    {k: W[k] for k in self.trained}, grads).items()}}
                losses.append(total)
        return Result(losses, norms(g1), norms({k: W[k] - self.W0[k] for k in self.trained}))

    def check(self) -> List[Tuple[str, float, float]]:
        ref = self.reference()
        got = compare(self.prog, ref)
        got.update(self.extra_checks())
        lim = self.traffic["limits"]
        return [(k, float(got[k]), float(lim[k])) for k in lim]

    def extra_checks(self) -> Dict[str, float]:
        return {}

    def meta_weights(self) -> Dict[str, torch.Tensor]:
        return {k: torch.empty(s[0], device="meta", requires_grad=s[1] != "buffer")
                for k, s in self.specs.items()}

    def work(self) -> List[dict]:
        """The products of one step, counted from the shapes (harness/work.py)."""
        if getattr(self, "_ops", None) is None:
            from reference.models import Ctx

            self._ops = []
            self.meta_step(Ctx(ops=self._ops, trained=True))
        return self._ops

    def program_readings(self) -> Dict[str, float]:
        self.leaves = {}
        return {**compare(self.prog, self.reference(), self.leaves), **self.extra_checks()}

    def readings(self) -> Dict[str, Dict[str, float]]:
        """The calibration's readings of this seed: the program against the reference,
        the control (the reference in fp8) and the planted faults against it."""
        ref = self.reference()
        self.leaves = {}
        out = {"program": {**compare(self.prog, ref, self.leaves), **self.extra_checks()},
               "control": compare(self.reference("fp8"), ref)}
        for fault in self.traffic.get("reference_faults", []):
            out[fault] = compare(self.reference(fault=fault), ref)
        out["unchanged"] = compare(Result(self.prog.losses, self.prog.grad,
                                          {k: 0.0 for k in ref.change}), ref)
        return out
