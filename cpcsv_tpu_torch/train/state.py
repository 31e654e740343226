"""Train state: the generator and the three discriminators, each with its own
Adam optimizer (counterpart of `cpcsv_tpu/train/state.py`; reference
`trainer.py:212-220`).

Adam has β = (0.5, 0.999) and eps 1e-8. The learning rate is not part of the
state: the train steps set it on every call, as the JAX steps take `lr` as
an argument (`state.py:66-70`). `Adam` computes optax's `scale_by_adam`
followed by −lr·u, with the first moment stored in cfg.ADAM_MU_DTYPE
(`cpcsv_tpu/train/state.py:26-41`). A net's BN running statistics and SN
vectors live in its buffers, as its `batch_stats` and `spectral`
collections do in JAX. Without SEGMENT_LEARNING there is no seg D: `d_se` is
None, and `nets()` and `opts` leave it out (three Adams, not four), as the
JAX state's `d_se` is None.

In a process group every rank builds its state from the same seed, and
`create_train_state` checks that they did (`check_replicas`): the steps
keep the replicas equal bit for bit from there (`train/steps.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.device import resolve_device
from cpcsv_tpu_torch.models.factory import build_models
from cpcsv_tpu_torch.parallel.distributed import is_distributed

NETS = ("gen", "d_im", "d_st", "d_se")


@dataclasses.dataclass
class TrainState:
    gen: nn.Module
    d_im: nn.Module
    d_st: nn.Module
    d_se: Optional[nn.Module]
    opts: dict[str, Adam]  # keyed by the names of nets()
    step: int = 0

    def nets(self) -> dict[str, nn.Module]:
        """The nets the state has, by name, in NETS order."""
        return {name: getattr(self, name) for name in NETS if getattr(self, name) is not None}


# cfg.ADAM_MU_DTYPE -> the first moment's dtype (None: the parameter's, as
# optax's mu_dtype=None and torch.optim.Adam keep it)
MU_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class Adam(torch.optim.Optimizer):
    """Adam whose first moment may be stored in bfloat16 beside float32
    parameters: optax's `scale_by_adam(mu_dtype=...)`, which
    `torch.optim.Adam` cannot do; and whose step a CUDA graph can capture.

    One step, in torch.optim.Adam's (foreach) arithmetic and state layout
    (`step`, `exp_avg`, `exp_avg_sq`), so that with a float32 moment it
    gives torch.optim.Adam's bits and reads its state_dicts:
      m  = lerp(float32(stored m), g, 1 − β1)      in float32
      v  = β2·v + (1 − β2)·g²                        float32
      p −= lr/(1 − β1^t) · m / (√v/√(1 − β2^t) + eps)   float32
      stored m = m in `mu_dtype` (rounded to nearest even), as optax casts
      the new moment only after it has used it; mu_dtype None keeps it in
      the parameter's dtype.
    A loaded state_dict's first moments are cast to `mu_dtype`, so a run may
    flip ADAM_MU_DTYPE between resumes.

    Nothing of a step is read on the host, so a CUDA graph of it replays
    right (`train/graphs.py`): the step count `t` lives on the parameters'
    device (a loaded CPU `step` moves there), the learning rate in the
    float64 device tensor `lr`, which `set_lr` writes in place (a float
    assigned to a group's "lr" is taken up by the next eager step), and the
    scalars −lr/(1 − β1^t) and √(1 − β2^t) are formed on the device in
    float64 and rounded once to float32, as torch.optim.Adam forms them in
    Python floats and its kernels round them. The last update rounds as
    the addcdiv kernels do: p + (s·m)/d on the CPU, one fused multiply-add
    of s and m/d into p on CUDA (one addcmul launch a parameter)."""

    def __init__(self, params, mu_dtype: Optional[torch.dtype] = None,
                 betas: tuple[float, float] = (0.5, 0.999), eps: float = 1e-8):
        super().__init__(params, {"lr": 0.0, "betas": betas, "eps": eps})
        self.mu_dtype = mu_dtype
        device = self.param_groups[0]["params"][0].device
        self.lr = torch.zeros((), dtype=torch.float64, device=device)
        self._lr_set = 0.0  # the value `lr` holds, known on the host

    def set_lr(self, lr: float) -> None:
        """The learning rate of the next steps, written into `lr` in place
        (and into every group's "lr", as torch.optim.Adam keeps it). Never
        inside a CUDA graph capture: the graph would replay this value."""
        if self.lr.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("set the learning rate before a CUDA graph captures the step")
        self.lr.fill_(lr)
        self._lr_set = lr
        for group in self.param_groups:
            group["lr"] = lr

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            if group["lr"] != self._lr_set:  # assigned to the group since
                self.set_lr(group["lr"])
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p)
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            stored = [s["exp_avg"] for s in states]
            mu = [m if m.dtype == p.dtype else m.to(p.dtype) for m, p in zip(stored, params)]
            nu = [s["exp_avg_sq"] for s in states]
            steps = [s["step"] for s in states]
            (b1, b2), eps = group["betas"], group["eps"]
            torch._foreach_add_(steps, 1)
            torch._foreach_lerp_(mu, grads, 1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
            # every parameter of a group steps together: one t for all
            t = steps[0].to(torch.float64)
            step_size = (self.lr / (1 - torch.pow(b1, t)) * -1).float()
            denom = torch._foreach_sqrt(nu)
            torch._foreach_div_(denom, torch.sqrt(1 - torch.pow(b2, t)).float())
            torch._foreach_add_(denom, eps)
            if params[0].device.type == "cpu":  # addcdiv's CPU kernel: p + (s·m)/d
                update = torch._foreach_mul(mu, step_size)
                torch._foreach_div_(update, denom)
                torch._foreach_add_(params, update)
            else:  # its CUDA kernel: fma(s, m/d, p), which addcmul's gives
                for p, u in zip(params, torch._foreach_div(mu, denom)):
                    p.addcmul_(u, step_size)
            if any(a is not b for a, b in zip(mu, stored)):
                torch._foreach_copy_(stored, mu)

    def __getstate__(self):  # torch.optim.Optimizer's pickles its defaults, state and groups only
        return {**super().__getstate__(), "mu_dtype": self.mu_dtype, "lr": self.lr,
                "_lr_set": self._lr_set}

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)  # casts every moment to its parameter's dtype
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p, {})
                if "step" in state:  # a CPU step, as torch.optim.Adam keeps it
                    state["step"] = state["step"].to(device=p.device, dtype=torch.float32)
                if self.mu_dtype is not None and "exp_avg" in state:
                    state["exp_avg"] = state["exp_avg"].to(self.mu_dtype)


def make_adam(params, mu_dtype: str = "float32") -> Adam:
    """Adam(β = 0.5, 0.999, eps 1e-8), its first moment in `mu_dtype`
    (cfg.ADAM_MU_DTYPE); the steps set the learning rate."""
    if mu_dtype not in MU_DTYPES:
        raise ValueError(f"ADAM_MU_DTYPE must be 'float32' or 'bfloat16', got {mu_dtype!r}")
    return Adam(params, MU_DTYPES[mu_dtype])


@torch.no_grad()
def weights_init(net: nn.Module, generator: torch.Generator) -> None:
    """The reference init (`miscc/utils.py:191-201`, the JAX package's
    initializers): conv and linear weights N(0, 0.02), their biases 0, BN
    scale N(1, 0.02) and bias 0 with fresh running statistics; GRU cells
    keep torch's U(−1/√H, 1/√H). A spectral-normed conv's u is drawn anew
    and its v is the u's next power-iteration v. All draws from `generator`."""
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            weight = getattr(mod, "weight_orig", mod.weight)
            weight.normal_(0.0, 0.02, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
            if hasattr(mod, "weight_u"):
                u = torch.randn(mod.weight_u.shape, generator=generator, device=weight.device)
                mod.weight_u.copy_(F.normalize(u, dim=0, eps=1e-12))
                w_mat = weight.reshape(weight.shape[0], -1)
                mod.weight_v.copy_(F.normalize(w_mat.t() @ mod.weight_u, dim=0, eps=1e-12))
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.weight.normal_(1.0, 0.02, generator=generator)
            mod.bias.zero_()
            mod.reset_running_stats()
        elif isinstance(mod, nn.GRUCell):
            bound = mod.hidden_size ** -0.5
            for p in mod.parameters():
                p.uniform_(-bound, bound, generator=generator)


def create_train_state(cfg: Config, seed: int = 0, device: str | torch.device = "cuda") -> TrainState:
    """The nets of `cfg` (`models.factory.build_models`), in train mode,
    initialised from `seed` on `device`, with their optimizers. It runs on
    the card unless the caller passes device="cpu". In a process group it
    checks that every rank built the same state."""
    dev = resolve_device(device)
    state = TrainState(*build_models(cfg), opts={})
    generator = torch.Generator(device=dev).manual_seed(seed)
    for name, net in state.nets().items():
        net.to(dev).train()
        weights_init(net, generator)
        state.opts[name] = make_adam(net.parameters(), cfg.ADAM_MU_DTYPE)
    check_replicas(state)
    return state


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def state_checksums(state: TrainState) -> torch.Tensor:
    """int64 sums of the bit patterns of every tensor of the state (the nets'
    parameters and buffers, the Adam states), one a tensor, on the nets'
    device: integer sums, exact in any order, that two states equal bit for
    bit share."""
    dev = next(state.gen.parameters()).device
    tensors = [t for net in state.nets().values() for t in net.state_dict().values()]
    tensors += [v for opt in state.opts.values() for st in opt.state.values()
                for v in st.values() if torch.is_tensor(v)]
    return torch.stack([t.detach().to(dev).contiguous().view(_BITS[t.element_size()])
                        .sum(dtype=torch.int64) for t in tensors])


def check_replicas(state: TrainState) -> None:
    """In a process group, RuntimeError unless every rank's state equals rank
    0's bit for bit (rank 0's checksums broadcast and compared)."""
    if not is_distributed():
        return
    ours = state_checksums(state)
    ref = ours.clone()
    dist.broadcast(ref, src=0)
    if not torch.equal(ours, ref):
        bad = int((ours != ref).sum())
        raise RuntimeError(
            f"rank {dist.get_rank()}: {bad} of {ours.numel()} state tensors differ from rank 0's; "
            "every rank must build its state from the same config and seed")
