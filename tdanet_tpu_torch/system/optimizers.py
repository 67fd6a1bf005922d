"""Optimizer factory over ``torch.optim`` (counterpart of
``tdanet_tpu/system/optimizers.py``, which builds optax transformations).

``make_optimizer(name, lr=..., grad_clip=..., **kw)`` resolves a name
(case-insensitive) to an :class:`Optimizer`: a factory whose ``init``
builds the optimizer over a model's parameters, and the global-norm clip
that goes before its step. The names are the JAX package's 32, and each
makes that package's optax update (optax 0.2.6; checked against it in
``tests/test_torch_optimizers.py``):

- a ``torch.optim`` class where it computes optax's update: adam (decoupled
  weight decay when ``weight_decay > 0``, as ``optax.adamw``), adamw, sgd
  (momentum, nesterov, coupled weight decay), adadelta, adamax;
- elsewhere a rule of this module written from optax's source, a
  ``torch.optim.Optimizer`` with its state in ``self.state[p]``: rmsprop
  (eps inside the root), adagrad, radam, nadam and nadamw (optax's
  nesterov Adam, not torch's momentum schedule), adamaxw, lamb, lars,
  novograd, yogi, adabelief, fromage, sm3, adafactor, lion;
- the JAX package's own aliases: sgdw and asgd are sgd; adabound is
  adabelief; diffgrad, qhadam and adamod are plain ``Adam(lr)``; accsgd,
  qhm and pid are ``SGD(lr, momentum=0.9)``; ranger, rangerqh and rangerva
  are radam. They are that package's analogs, not the torch-optimizer
  classes of those names.

Each name honours the keyword arguments its JAX factory honours, with that
factory's defaults, and drops the rest. Every rule reads the learning rate
from its parameter group at each ``step()``, so a host-side scheduler's
:func:`set_learning_rate` between steps changes the next update wherever
the rule uses it (``optax.inject_hyperparams``). A step reads no tensor's
value on the host: the step count is a host integer, and trust ratios and
zero guards are ``torch.where`` on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _adam(params, lr, weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8, **kw):
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


def _adamw(params, lr, weight_decay=1e-2, betas=(0.9, 0.999), eps=1e-8,
           **kw):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, momentum=0.0, weight_decay=0.0, nesterov=False, **kw):
    # optax.sgd drops nesterov without momentum; torch.optim.SGD raises
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay,
                           nesterov=bool(nesterov and momentum))


def _rmsprop(params, lr, alpha=0.99, eps=1e-8, momentum=0.0, **kw):
    return RMSProp(params, lr, decay=alpha, eps=eps, momentum=momentum)


# -- the rules ----------------------------------------------------------------

def _ema_(moments, xs, decay):
    """moment = (1 - decay) x + decay moment, in place."""
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, torch._foreach_mul(xs, 1 - decay))


def _square(xs):
    return torch._foreach_mul(xs, xs)


def _bias_correct(moments, decay, count):
    return torch._foreach_div(moments, 1 - decay ** count)


def _adam_direction(mu_hat, nu_hat, eps):
    """mu_hat / (sqrt(nu_hat) + eps)."""
    denom = torch._foreach_sqrt(nu_hat)
    torch._foreach_add_(denom, eps)
    return torch._foreach_div(mu_hat, denom)


def _trust_ratios(params, updates, coefficient=1.0, min_norm=0.0):
    """optax.scale_by_trust_ratio's factor per tensor: coefficient *
    |p| / |u| with each norm at least ``min_norm``, and 1 where either is
    0; 0-d tensors on the device."""
    p_norms = torch._foreach_norm(params)
    u_norms = torch._foreach_norm(updates)
    if min_norm:
        torch._foreach_clamp_min_(p_norms, min_norm)
        torch._foreach_clamp_min_(u_norms, min_norm)
    return [torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                        coefficient * pn / un)
            for pn, un in zip(p_norms, u_norms)]


class _Rule(torch.optim.Optimizer):
    """An optax rule as a ``torch.optim.Optimizer``: ``_init(p)`` gives a
    parameter's state; ``_updates(group, params, grads, states, count)``
    returns what is added to each parameter at step ``count`` (1 at the
    first step), the learning rate read from ``group``."""

    def __init__(self, params, lr, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))

    def _init(self, p):
        return {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                state = self.state[p]
                if not state:
                    state.update(self._init(p), step=0)
                states.append(state)
            count = states[0]["step"] + 1
            updates = self._updates(group, params, [p.grad for p in params],
                                    states, count)
            torch._foreach_add_(params, updates)
            for state in states:
                state["step"] = count
        return loss


def _stack(states, key):
    return [s[key] for s in states]


class RMSProp(_Rule):
    """optax.rmsprop: nu from 0, g / sqrt(nu + eps), times -lr, then a
    trace of the scaled updates when ``momentum``."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, momentum=0.0):
        super().__init__(params, lr, decay=decay, eps=eps, momentum=momentum)

    def _init(self, p):
        state = {"nu": torch.zeros_like(p)}
        if self.defaults["momentum"]:
            state["trace"] = torch.zeros_like(p)
        return state

    def _updates(self, group, params, grads, states, count):
        nu = _stack(states, "nu")
        _ema_(nu, _square(grads), group["decay"])
        scale = torch._foreach_add(nu, group["eps"])
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(updates, -group["lr"])
        if not group["momentum"]:
            return updates
        trace = _stack(states, "trace")
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, updates)
        return trace


class Adagrad(_Rule):
    """optax.adagrad: the sum of squares from 0.1, g / sqrt(sum + 1e-7)."""

    INITIAL, EPS = 0.1, 1e-7

    def _init(self, p):
        return {"sum_of_squares": torch.full_like(p, self.INITIAL)}

    def _updates(self, group, params, grads, states, count):
        sos = _stack(states, "sum_of_squares")
        torch._foreach_add_(sos, _square(grads))
        # optax's where(sum > 0, ...): the sum starts at INITIAL > 0
        scale = torch._foreach_add(sos, self.EPS)
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class _Moments(_Rule):
    """A rule with optax's first and second moments ``mu``, ``nu``, both
    from ``INITIAL``, and its Adam constants."""

    B1, B2, EPS, INITIAL = 0.9, 0.999, 1e-8, 0.0

    def _init(self, p):
        return {"mu": torch.full_like(p, self.INITIAL),
                "nu": torch.full_like(p, self.INITIAL)}

    def _moments(self, grads, states):
        """mu and nu moved by the gradients (Adam's), in place."""
        mu, nu = _stack(states, "mu"), _stack(states, "nu")
        _ema_(mu, grads, self.B1)
        _ema_(nu, _square(grads), self.B2)
        return mu, nu


class NAdam(_Moments):
    """optax.adam(nesterov=True) (nadam), with optax.adamw's decoupled
    weight decay (nadamw) when ``weight_decay``."""

    def __init__(self, params, lr, weight_decay=0.0):
        super().__init__(params, lr, weight_decay=weight_decay)

    def _updates(self, group, params, grads, states, count):
        b1 = self.B1
        mu, nu = self._moments(grads, states)
        mu_hat = torch._foreach_div(mu, 1 - b1 ** (count + 1))
        torch._foreach_mul_(mu_hat, b1)
        g_hat = torch._foreach_div(grads, 1 - b1 ** count)
        torch._foreach_mul_(g_hat, 1 - b1)
        torch._foreach_add_(mu_hat, g_hat)
        updates = _adam_direction(mu_hat, _bias_correct(nu, self.B2, count),
                                  self.EPS)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class RAdam(_Moments):
    """optax.radam: Adam's step rectified once rho_t reaches 5, the
    bias-corrected first moment alone before. rho_t is a function of the
    step count, so the branch is on the host."""

    THRESHOLD = 5.0

    def _updates(self, group, params, grads, states, count):
        b1, b2 = self.B1, self.B2
        mu, nu = self._moments(grads, states)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mu_hat = _bias_correct(mu, b1, count)
        if ro >= self.THRESHOLD:
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            updates = _adam_direction(torch._foreach_mul(mu_hat, r),
                                      _bias_correct(nu, b2, count), self.EPS)
        else:
            updates = mu_hat
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class Yogi(_Moments):
    """optax.yogi: both moments from 1e-6, nu moves by -(1 - b2)
    sign(nu - g^2) g^2, eps 1e-3 outside the root."""

    EPS, INITIAL = 1e-3, 1e-6

    def _updates(self, group, params, grads, states, count):
        mu, nu = _stack(states, "mu"), _stack(states, "nu")
        _ema_(mu, grads, self.B1)
        g2 = _square(grads)
        sign = torch._foreach_sub(nu, g2)
        torch._foreach_sign_(sign)
        torch._foreach_mul_(sign, g2)
        torch._foreach_add_(nu, sign, alpha=-(1 - self.B2))
        updates = _adam_direction(_bias_correct(mu, self.B1, count),
                                  _bias_correct(nu, self.B2, count),
                                  self.EPS)
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class AdaBelief(_Moments):
    """optax.adabelief: nu is the moment of (g - mu)^2 plus eps_root, kept
    in the state; eps and eps_root 1e-16."""

    EPS = EPS_ROOT = 1e-16

    def _updates(self, group, params, grads, states, count):
        mu, nu = _stack(states, "mu"), _stack(states, "nu")
        _ema_(mu, grads, self.B1)
        _ema_(nu, _square(torch._foreach_sub(grads, mu)), self.B2)
        torch._foreach_add_(nu, self.EPS_ROOT)
        updates = _adam_direction(_bias_correct(mu, self.B1, count),
                                  _bias_correct(nu, self.B2, count),
                                  self.EPS)
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class AdamaxW(_Moments):
    """optax.adamaxw: Adamax's step plus the decoupled weight decay, times
    -lr."""

    def __init__(self, params, lr, weight_decay=1e-4):
        super().__init__(params, lr, weight_decay=weight_decay)

    def _updates(self, group, params, grads, states, count):
        mu, nu = _stack(states, "mu"), _stack(states, "nu")
        _ema_(mu, grads, self.B1)
        torch._foreach_mul_(nu, self.B2)
        abs_eps = torch._foreach_abs(grads)
        torch._foreach_add_(abs_eps, self.EPS)
        torch._foreach_maximum_(nu, abs_eps)
        updates = _bias_correct(mu, self.B1, count)
        torch._foreach_div_(updates, nu)
        torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class Lamb(_Moments):
    """optax.lamb: Adam's step (eps 1e-6) plus weight decay, times the
    per-tensor trust ratio |p| / |u| (1 where a norm is 0), times -lr."""

    EPS = 1e-6

    def __init__(self, params, lr, weight_decay=0.0):
        super().__init__(params, lr, weight_decay=weight_decay)

    def _updates(self, group, params, grads, states, count):
        mu, nu = self._moments(grads, states)
        updates = _adam_direction(_bias_correct(mu, self.B1, count),
                                  _bias_correct(nu, self.B2, count),
                                  self.EPS)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        torch._foreach_mul_(updates, _trust_ratios(params, updates))
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class Lars(_Rule):
    """optax.lars: (g + weight_decay p) times the trust ratio 0.001 |p| /
    |u| (1 where a norm is 0), times -lr, then a trace of momentum 0.9."""

    TRUST_COEFFICIENT, MOMENTUM = 1e-3, 0.9

    def __init__(self, params, lr, weight_decay=0.0):
        super().__init__(params, lr, weight_decay=weight_decay)

    def _init(self, p):
        return {"trace": torch.zeros_like(p)}

    def _updates(self, group, params, grads, states, count):
        updates = torch._foreach_add(grads, params,
                                     alpha=group["weight_decay"])
        torch._foreach_mul_(updates, _trust_ratios(
            params, updates, self.TRUST_COEFFICIENT))
        torch._foreach_mul_(updates, -group["lr"])
        trace = _stack(states, "trace")
        torch._foreach_mul_(trace, self.MOMENTUM)
        torch._foreach_add_(trace, updates)
        return trace


class NovoGrad(_Rule):
    """optax.novograd: a per-tensor second moment of |g|^2 (b2 0.25),
    started from the first gradient's; mu = b1 mu + g / (sqrt(nu) + eps) +
    weight_decay p, started from that sum; times -lr."""

    B1, B2, EPS = 0.9, 0.25, 1e-6

    def __init__(self, params, lr, weight_decay=0.0):
        super().__init__(params, lr, weight_decay=weight_decay)

    def _init(self, p):
        return {"mu": torch.zeros_like(p),
                "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def _updates(self, group, params, grads, states, count):
        mu, nu = _stack(states, "mu"), _stack(states, "nu")
        norms = torch._foreach_norm(grads)
        torch._foreach_mul_(norms, norms)
        if count == 1:
            torch._foreach_copy_(nu, norms)
        else:
            _ema_(nu, norms, self.B2)
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, self.EPS)
        add = torch._foreach_div(grads, denom)
        if group["weight_decay"]:
            torch._foreach_add_(add, params, alpha=group["weight_decay"])
        if count == 1:
            torch._foreach_copy_(mu, add)
        else:
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, add)
        return torch._foreach_mul(mu, -group["lr"])


class Fromage(_Rule):
    """optax.fromage: g times |p| / |g| (norms at least 1e-6), times
    -lr / sqrt(1 + lr^2), plus (1 / sqrt(1 + lr^2) - 1) p; both factors
    from the learning rate of the current step."""

    MIN_NORM = 1e-6

    def _updates(self, group, params, grads, states, count):
        lr = group["lr"]
        mult = 1 / math.sqrt(1 + lr ** 2)
        updates = torch._foreach_mul(grads, _trust_ratios(
            params, grads, min_norm=self.MIN_NORM))
        torch._foreach_mul_(updates, -(lr * mult))
        torch._foreach_add_(updates, params, alpha=mult - 1)
        return updates


class Lion(_Rule):
    """optax.lion: sign((1 - b1) g + b1 mu) plus weight_decay p, times -lr;
    then mu = (1 - b2) g + b2 mu."""

    B1, B2 = 0.9, 0.99

    def __init__(self, params, lr, weight_decay=1e-3):
        super().__init__(params, lr, weight_decay=weight_decay)

    def _init(self, p):
        return {"mu": torch.zeros_like(p)}

    def _updates(self, group, params, grads, states, count):
        mu = _stack(states, "mu")
        updates = torch._foreach_mul(grads, 1.0 - self.B1)
        torch._foreach_add_(updates, torch._foreach_mul(mu, self.B1))
        torch._foreach_sign_(updates)
        _ema_(mu, grads, self.B2)
        if group["weight_decay"]:
            torch._foreach_add_(updates, params, alpha=group["weight_decay"])
        torch._foreach_mul_(updates, -group["lr"])
        return updates


class SM3(_Rule):
    """optax.sm3: one accumulator per dimension of each tensor (the
    elementwise one for 0-d and 1-d tensors), g / sqrt(acc + 1e-8) (0
    where acc is 0), momentum 0.9, times -lr."""

    MOMENTUM, EPS = 0.9, 1e-8

    def _init(self, p):
        return {"acc": [p.new_zeros(n) for n in p.shape],
                "mu": torch.zeros_like(p)}

    def _updates(self, group, params, grads, states, count):
        b1, updates = self.MOMENTUM, []
        for g, state in zip(grads, states):
            acc = state["acc"]
            if g.ndim < 2:
                accum = g * g + acc[0]
            else:
                views = [a.view([1] * i + [-1] + [1] * (g.ndim - i - 1))
                         for i, a in enumerate(acc)]
                least = views[0]
                for v in views[1:]:
                    least = torch.minimum(least, v)
                accum = g * g + least
            scale = torch.where(accum > 0, (accum + self.EPS).rsqrt(),
                                torch.zeros_like(accum))
            mu = state["mu"]
            mu.mul_(b1).add_((1.0 - b1) * (g * scale))
            if g.ndim < 2:
                acc[0].copy_(accum)
            else:
                for i, a in enumerate(acc):
                    a.copy_(accum.amax(dim=[d for d in range(g.ndim)
                                            if d != i]))
            updates.append(mu * -group["lr"])
        return updates


def _factored_dims(shape, min_dim_size_to_factor):
    """optax's choice: the two largest dims (numpy's argsort order) when
    the second largest is at least ``min_dim_size_to_factor``, else
    None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_Rule):
    """optax.adafactor with its defaults: the second moment factored into
    row and column means over the two largest dims where both are at
    least 128 (elementwise elsewhere), decay 1 - (t + 1)^-0.8 in float32 as
    optax computes it, eps 1e-30 on g^2, the update clipped to block RMS
    1, times lr, times the parameter's RMS (at least 1e-3), negated."""

    MIN_DIM, DECAY_RATE, CLIP, MIN_SCALE, EPS = 128, 0.8, 1.0, 1e-3, 1e-30

    def _init(self, p):
        dims = _factored_dims(p.shape, self.MIN_DIM)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": p.new_zeros([n for i, n in enumerate(p.shape)
                                      if i != d0]),
                "v_col": p.new_zeros([n for i, n in enumerate(p.shape)
                                      if i != d1])}

    def _updates(self, group, params, grads, states, count):
        # optax: t = step + 1 with step from 0, in float32
        decay = np.float32(1.0) - np.float32(count) ** np.float32(
            -self.DECAY_RATE)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        updates = []
        for p, g, state in zip(params, grads, states):
            grad_sqr = g * g + self.EPS
            dims = _factored_dims(p.shape, self.MIN_DIM)
            if dims is None:
                v = state["v"]
                v.mul_(keep).add_(take * grad_sqr)
                u = g * v.pow(-0.5)
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"], state["v_col"]
                v_row.mul_(keep).add_(take * grad_sqr.mean(dim=d0))
                v_col.mul_(keep).add_(take * grad_sqr.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
                row_factor = (v_row / row_col_mean).pow(-0.5)
                col_factor = v_col.pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            rms = u.square().mean().sqrt()
            u = u / torch.clamp_min(rms / self.CLIP, 1.0)
            u = u * group["lr"]
            p_rms = torch.clamp_min(p.square().mean().sqrt(), self.MIN_SCALE)
            updates.append(-(u * p_rms))
        return updates


def _plain_adam(params, lr, **kw):
    return torch.optim.Adam(params, lr=lr)


def _momentum_sgd(params, lr, **kw):
    return torch.optim.SGD(params, lr=lr, momentum=0.9)


def _radam(params, lr, **kw):
    return RAdam(params, lr)


def _adabelief(params, lr, **kw):
    return AdaBelief(params, lr)


_FACTORIES = {
    "adam": _adam,
    "adamw": _adamw,
    "sgd": _sgd,
    "sgdw": _sgd,
    "asgd": _sgd,
    "rmsprop": _rmsprop,
    # optax.adadelta(lr) and optax.adamax(lr) with optax's defaults, which
    # are torch's
    "adadelta": lambda params, lr, **kw: torch.optim.Adadelta(params, lr=lr),
    "adagrad": lambda params, lr, **kw: Adagrad(params, lr),
    "adamax": lambda params, lr, **kw: torch.optim.Adamax(params, lr=lr),
    "adamaxw": lambda params, lr, weight_decay=1e-2, **kw: AdamaxW(
        params, lr, weight_decay=weight_decay),
    "lamb": lambda params, lr, weight_decay=0.0, **kw: Lamb(
        params, lr, weight_decay=weight_decay),
    "lars": lambda params, lr, weight_decay=0.0, **kw: Lars(
        params, lr, weight_decay=weight_decay),
    "novograd": lambda params, lr, weight_decay=0.0, **kw: NovoGrad(
        params, lr, weight_decay=weight_decay),
    "radam": _radam,
    "yogi": lambda params, lr, **kw: Yogi(params, lr),
    "adabelief": _adabelief,
    "adabound": _adabelief,  # the JAX package's closest optax analog
    "fromage": lambda params, lr, **kw: Fromage(params, lr),
    "sm3": lambda params, lr, **kw: SM3(params, lr),
    "adafactor": lambda params, lr, **kw: Adafactor(params, lr),
    "lion": lambda params, lr, weight_decay=0.0, **kw: Lion(
        params, lr, weight_decay=weight_decay),
    "nadam": lambda params, lr, **kw: NAdam(params, lr),
    "nadamw": lambda params, lr, weight_decay=1e-2, **kw: NAdam(
        params, lr, weight_decay=weight_decay),
    # the JAX package's fallback analogs
    "diffgrad": _plain_adam,
    "accsgd": _momentum_sgd,
    "qhadam": _plain_adam,
    "qhm": _momentum_sgd,
    "pid": _momentum_sgd,
    "adamod": _plain_adam,
    "ranger": _radam,
    "rangerqh": _radam,
    "rangerva": _radam,
}

_CUSTOM = {}


def register_optimizer(name: str, factory):
    """Register ``factory(params, lr, **kw) -> torch.optim.Optimizer``."""
    key = name.lower()
    if key in _FACTORIES or key in _CUSTOM:
        raise ValueError(f"Optimizer {name} already exists.")
    _CUSTOM[key] = factory


def get(identifier):
    if callable(identifier):
        return identifier
    f = {**_FACTORIES, **_CUSTOM}.get(str(identifier).lower())
    if f is None:
        raise ValueError(f"Could not interpret optimizer: {identifier}")
    return f


def clip_by_global_norm_(grads, max_norm):
    """optax.clip_by_global_norm in place: when the global norm
    sqrt(sum g^2) is at least ``max_norm`` every gradient becomes
    g / norm * max_norm (no 1e-6 is added to the norm, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm, on the device."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """A named optimizer with its learning rate, options and global-norm
    clip. ``init(params)`` builds the torch.optim optimizer;
    ``clip_(grads)`` clips in place when a clip was given."""

    def __init__(self, factory, lr, grad_clip=None, **kwargs):
        self.factory, self.lr, self.grad_clip = factory, lr, grad_clip
        self.kwargs = kwargs

    def init(self, params):
        return self.factory(list(params), lr=self.lr, **self.kwargs)

    def clip_(self, grads):
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)


def make_optimizer(optim_name="adam", lr=1e-3, grad_clip=None,
                   **kwargs) -> Optimizer:
    """The optimizer ``optim_name`` (case-insensitive) with an optional
    global-norm clip before its step."""
    return Optimizer(get(optim_name), lr, grad_clip, **kwargs)


def set_learning_rate(opt_state, lr):
    """Set the learning rate of every parameter group of a torch.optim
    optimizer; returns it."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state


def get_learning_rate(opt_state):
    return opt_state.param_groups[0]["lr"]
