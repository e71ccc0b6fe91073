"""Random sampling ops (counterpart of `mxnet_tpu/ops/random_ops.py`;
reference: src/operator/random/sample_op.cc, multisample_op.cc,
shuffle_op.cc, sample_multinomial_op.cc, unique_sample_op.cc).

Every drawing op takes a ``generator`` keyword, the `torch.Generator` its
caller chose (``mx.nd`` passes this thread's generator for the op's device,
`random.generator`), and draws on that generator's device. Threefry and
Philox give different numbers from the same seed, so only distributions
(and greedy decoding) are comparable across the two packages; a seed gives
the same bits twice on one device.

The ``_random_*`` ops draw ``shape`` samples of one distribution; the
``_sample_*`` ops draw ``shape`` samples from each distribution of their
array parameters (output ``param.shape + shape``). Gamma draws are
Marsaglia and Tsang's rejection method over the generator's normals and
uniforms (``torch._standard_gamma`` takes no generator), with alpha < 1
boosted by ``U ** (1 / alpha)``; the binomial family is a gamma-Poisson
mixture, as in the JAX package.

`sample_token_logits` is the decode loop's sampler: greedy where
temperature <= 0, else a temperature-scaled categorical over the
top-k/top-p-filtered logits, with per-row parameters so one mixed batch of
greedy and stochastic requests is one call. The filters keep the JAX
package's tie rule (``logits >= thr``).

``GridGenerator``, ``BilinearSampler`` and ``SpatialTransformer`` draw
nothing; they live here because the JAX package registers them here.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import torch_dtype
from . import register

__all__ = ["sample_token_logits"]


def _gen(generator, like=None):
    """The op's generator: the caller's, else this thread's for the device
    of ``like`` (an array input), else for the current context."""
    if generator is not None:
        return generator
    if like is not None:
        return _random.generator(like.device)
    from ..context import resolve_device

    return _random.generator(resolve_device(None))


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _uniform(shape, gen):
    return torch.rand(shape, generator=gen, device=gen.device)


def _normal(shape, gen):
    return torch.randn(shape, generator=gen, device=gen.device)


def _standard_gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one for each element of the f32 tensor
    ``alpha`` (Marsaglia and Tsang, 2000: a squeeze-free rejection over
    normals; alpha < 1 draws Gamma(alpha + 1) times U ** (1 / alpha))."""
    alpha = alpha.float()
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.arange(a.numel(), device=a.device)
    d_f, c_f, out_f = d.reshape(-1), c.reshape(-1), out.view(-1)
    while pending.numel():
        dd, cc = d_f[pending], c_f[pending]
        x = _normal(pending.shape, gen)
        u = _uniform(pending.shape, gen)
        v = (1.0 + cc * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v
                        + dd * torch.log(torch.clamp(v, min=1e-30)))
        out_f[pending[ok]] = (dd * v)[ok]
        pending = pending[~ok]
    if bool(boost.any()):
        u = _uniform(a.shape, gen)
        out = torch.where(boost, out * u ** (1.0 / alpha), out)
    return out


def _poisson(lam, gen):
    return torch.poisson(lam.float(), generator=gen)


def _full(value, shape, gen):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=gen.device)


# --------------------------------------------------------------------------
# one distribution, ``shape`` draws
# --------------------------------------------------------------------------

@register("_random_uniform", needs_rng=True,
          aliases=("uniform", "random_uniform"))
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                   generator=None):
    gen = _gen(generator)
    out = _uniform(_shape(shape), gen) * (high - low) + low
    return out.to(torch_dtype(dtype))


@register("_random_normal", needs_rng=True,
          aliases=("normal", "random_normal"))
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                  generator=None):
    gen = _gen(generator)
    return (_normal(_shape(shape), gen) * scale + loc).to(torch_dtype(dtype))


@register("_random_gamma", needs_rng=True, aliases=("gamma_sample",))
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                 generator=None):
    gen = _gen(generator)
    draws = _standard_gamma(_full(alpha, _shape(shape), gen), gen)
    return (draws * beta).to(torch_dtype(dtype))


@register("_random_exponential", needs_rng=True)
def random_exponential(lam=1.0, shape=(), dtype="float32", generator=None):
    gen = _gen(generator)
    draws = torch.empty(_shape(shape), device=gen.device).exponential_(
        generator=gen)
    return (draws / lam).to(torch_dtype(dtype))


@register("_random_poisson", needs_rng=True)
def random_poisson(lam=1.0, shape=(), dtype="float32", generator=None):
    gen = _gen(generator)
    return _poisson(_full(lam, _shape(shape), gen), gen).to(
        torch_dtype(dtype))


@register("_random_negative_binomial", needs_rng=True)
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                             generator=None):
    gen = _gen(generator)
    lam = _standard_gamma(_full(k, _shape(shape), gen), gen) * ((1 - p) / p)
    return _poisson(lam, gen).to(torch_dtype(dtype))


@register("_random_generalized_negative_binomial", needs_rng=True)
def random_gen_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                 dtype="float32", generator=None):
    gen = _gen(generator)
    lam = _standard_gamma(_full(1.0 / alpha, _shape(shape), gen), gen) \
        * (alpha * mu)
    return _poisson(lam, gen).to(torch_dtype(dtype))


@register("_random_randint", needs_rng=True, aliases=("randint",))
def random_randint(low=0, high=1, shape=(), dtype="int32", generator=None):
    gen = _gen(generator)
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=gen.device, dtype=torch_dtype(dtype))


def _gumbel(shape, gen):
    u = _uniform(shape, gen).clamp_(min=1e-20, max=1.0 - 1e-7)
    return -torch.log(-torch.log(u))


@register("_sample_unique_zipfian", needs_rng=True,
          size_attrs=("range_max",))
def sample_unique_zipfian(range_max=1, shape=(), generator=None):
    """Unique draws a row from the log-uniform class distribution p(k) ∝
    log((k + 2) / (k + 1)), sampled without replacement by Gumbel-top-k
    (equal in distribution to the reference's draw-until-unique). Where
    rows x range_max exceeds 2^24, m = 4k + 32 draws by the inverse CDF,
    deduplicated a row, uniques first, as the JAX package does. int32."""
    gen = _gen(generator)
    shape = _shape(shape)
    rows, k = (shape[0], shape[1]) if len(shape) == 2 else (1, shape[0])
    dev = gen.device
    if rows * range_max <= (1 << 24):
        classes = torch.arange(range_max, device=dev, dtype=torch.float32)
        logp = torch.log(torch.log((classes + 2.0) / (classes + 1.0)))
        keys = logp.unsqueeze(0) + _gumbel((rows, range_max), gen)
        idx = torch.topk(keys, k, dim=1).indices
        return idx.reshape(shape).to(torch.int32)
    m = 4 * k + 32
    u = _uniform((rows, m), gen)
    draws = (torch.exp(u * math.log(float(range_max + 1))) - 1.0).to(
        torch.int32)
    s = torch.sort(torch.clamp(draws, 0, range_max - 1), dim=1).values
    dup = torch.cat([torch.zeros((rows, 1), dtype=torch.bool, device=dev),
                     s[:, 1:] == s[:, :-1]], dim=1)
    order = torch.sort(dup.to(torch.int8), dim=1, stable=True).indices
    return torch.gather(s, 1, order)[:, :k].reshape(shape).to(torch.int32)


def _multinomial_outputs(attrs):
    return 2 if attrs.get("get_prob") else 1


@register("_sample_multinomial", needs_rng=True, num_outputs=-1,
          num_outputs_fn=_multinomial_outputs,
          aliases=("sample_multinomial", "multinomial"))
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                       generator=None):
    """data (..., k) probabilities; ``shape`` draws from each distribution,
    output ``data.shape[:-1] + shape`` (a categorical over log(max(p,
    1e-30)), by Gumbel-max, as the JAX package's). With ``get_prob`` also
    the log-probability of each draw (reference:
    sample_multinomial_op.cc; the JAX package returns the draws only)."""
    gen = _gen(generator, data)
    samp = _shape(shape)
    n = 1
    for s in samp:
        n *= s
    k = data.shape[-1]
    logits = torch.log(torch.clamp(data.float(), min=1e-30)).reshape(-1, 1, k)
    keys = logits + _gumbel((logits.shape[0], n, k), gen)
    out = torch.argmax(keys, dim=-1).reshape(tuple(data.shape[:-1]) + samp)
    out_t = out.to(torch_dtype(dtype))
    if not get_prob:
        return out_t
    flat = data.reshape(-1, k)
    picked = torch.gather(flat, 1, out.reshape(flat.shape[0], -1))
    return out_t, torch.log(picked).reshape(out.shape).to(data.dtype)


@register("_shuffle", needs_rng=True, aliases=("shuffle",))
def shuffle(data, generator=None):
    """A random permutation of data's first axis."""
    gen = _gen(generator, data)
    perm = torch.randperm(data.shape[0], generator=gen, device=gen.device)
    return data[perm.to(data.device)]


# --------------------------------------------------------------------------
# token sampling (the decode loop)
# --------------------------------------------------------------------------

def _rows(value, logits, dtype):
    """Scalar or per-row parameter as a (...,) tensor on logits' device."""
    t = torch.as_tensor(value, dtype=dtype, device=logits.device)
    return torch.broadcast_to(t, logits.shape[:-1])


def _top_k_logits(logits, k):
    """Mask logits outside each row's top-k (k <= 0 disables; scalar or
    per-row k)."""
    v = logits.shape[-1]
    kk = _rows(k, logits, torch.int64)
    kk = torch.clamp(torch.where(kk <= 0, torch.full_like(kk, v), kk), 1, v)
    desc = torch.sort(logits, dim=-1, descending=True).values
    thr = torch.gather(desc, -1, (kk - 1).unsqueeze(-1))
    return torch.where(logits >= thr, logits,
                       torch.full_like(logits, float("-inf")))


def _top_p_logits(logits, p):
    """Nucleus filter: keep the smallest prefix of descending-probability
    tokens whose mass reaches p (always at least the argmax; p <= 0 or
    p >= 1 disables). Scalar or per-row p."""
    pp = _rows(p, logits, torch.float32)
    pp = torch.where((pp <= 0.0) | (pp >= 1.0), torch.ones_like(pp), pp)
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < pp.unsqueeze(-1)
    thr = torch.where(keep, desc, torch.full_like(desc, float("inf")))
    thr = thr.min(dim=-1, keepdim=True).values
    return torch.where(logits >= thr, logits,
                       torch.full_like(logits, float("-inf")))


def sample_token_logits(logits, temperature=1.0, top_k=0, top_p=1.0,
                        generator=None):
    """Sample one token id per row of ``logits`` (..., V). Parameters may be
    scalars or per-row arrays. ``generator`` must live on logits' device.
    The categorical draw is Gumbel-max over the generator's uniforms.
    Returns int32 (...)."""
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1)
    if not isinstance(temperature, torch.Tensor) \
            and not (torch.as_tensor(temperature) > 0.0).any():
        # an all-greedy batch, decided on the host: no filters, no draw
        return greedy.to(torch.int32)
    t = _rows(temperature, logits, torch.float32)
    masked = _top_p_logits(_top_k_logits(lf, top_k), top_p)
    scaled = masked / torch.clamp(t, min=1e-6).unsqueeze(-1)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20, max=1.0 - 1e-7)))
    drawn = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(t <= 0.0, greedy, drawn).to(torch.int32)


@register("_sample_token", needs_rng=True, aliases=("sample_token",))
def sample_token(data, temperature=1.0, top_k=0, top_p=1.0, dtype="int32",
                 generator=None):
    """data (..., V) logits -> (...) token ids, greedy / temperature /
    top-k / top-p by the attrs (`sample_token_logits`)."""
    gen = _gen(generator, data)
    out = sample_token_logits(data, temperature=float(temperature),
                              top_k=int(top_k), top_p=float(top_p),
                              generator=gen)
    return out.to(torch_dtype(dtype))


# --------------------------------------------------------------------------
# spatial transformer pieces (deterministic)
# --------------------------------------------------------------------------

@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=()):
    """``affine``: data (B, 6) -> sampling grid (B, 2, h, w) of x, y in
    [-1, 1]; ``warp``: data (B, 2, h, w) flow in pixels added to the
    identity grid, normalized."""
    h, w = (int(s) for s in target_shape) if transform_type == "affine" \
        else data.shape[2:]
    dev, dt = data.device, data.dtype
    ys = torch.linspace(-1.0, 1.0, h, device=dev, dtype=dt)
    xs = torch.linspace(-1.0, 1.0, w, device=dev, dtype=dt)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    if transform_type == "affine":
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones(h * w, device=dev, dtype=dt)])
        theta = data.reshape(-1, 2, 3)
        return torch.einsum("bij,jk->bik", theta, base).reshape(-1, 2, h, w)
    grid = torch.stack([gx, gy]).unsqueeze(0)
    norm = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], device=dev,
                        dtype=dt).reshape(1, 2, 1, 1)
    return grid + data / norm


@register("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=False):
    """Sample data (N, C, H, W) at the normalized grid (N, 2, H', W'), x
    then y in [-1, 1]; a corner outside the image reads 0 (reference:
    src/operator/bilinear_sampler.cc)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(n, c, h * w)

    def corner(yy, xx):
        yi = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xi = torch.clamp(xx.to(torch.int64), 0, w - 1)
        valid = ((yy >= 0) & (yy <= h - 1) & (xx >= 0)
                 & (xx <= w - 1)).to(data.dtype)
        idx = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(n, c, *yy.shape[1:])
        return vals * valid.unsqueeze(1)

    return (corner(y0, x0) * ((1 - wx) * (1 - wy)).unsqueeze(1)
            + corner(y0, x0 + 1) * (wx * (1 - wy)).unsqueeze(1)
            + corner(y0 + 1, x0) * ((1 - wx) * wy).unsqueeze(1)
            + corner(y0 + 1, x0 + 1) * (wx * wy).unsqueeze(1))


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(), transform_type="affine",
                        sampler_type="bilinear", cudnn_off=False):
    """`BilinearSampler` of data over the affine grid of ``loc`` (B, 6)."""
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


# --------------------------------------------------------------------------
# one distribution a parameter element, ``shape`` draws from each
# --------------------------------------------------------------------------

def _each(param, shape):
    """``param`` (f32) broadcast to ``param.shape + shape``."""
    p = param.float()
    return p.reshape(tuple(p.shape) + (1,) * len(shape)).expand(
        tuple(p.shape) + shape)


@register("_sample_uniform", needs_rng=True, aliases=("sample_uniform",))
def sample_uniform(low, high, shape=(), dtype="float32", generator=None):
    gen, s = _gen(generator, low), _shape(shape)
    lo, hi = _each(low, s), _each(high, s)
    return (_uniform(lo.shape, gen) * (hi - lo) + lo).to(torch_dtype(dtype))


@register("_sample_normal", needs_rng=True, aliases=("sample_normal",))
def sample_normal(mu, sigma, shape=(), dtype="float32", generator=None):
    gen, s = _gen(generator, mu), _shape(shape)
    m, sd = _each(mu, s), _each(sigma, s)
    return (_normal(m.shape, gen) * sd + m).to(torch_dtype(dtype))


@register("_sample_gamma", needs_rng=True, aliases=("sample_gamma",))
def sample_gamma(alpha, beta, shape=(), dtype="float32", generator=None):
    gen, s = _gen(generator, alpha), _shape(shape)
    draws = _standard_gamma(_each(alpha, s).contiguous(), gen)
    return (draws * _each(beta, s)).to(torch_dtype(dtype))


@register("_sample_exponential", needs_rng=True,
          aliases=("sample_exponential",))
def sample_exponential(lam, shape=(), dtype="float32", generator=None):
    gen, s = _gen(generator, lam), _shape(shape)
    rate = _each(lam, s)
    draws = torch.empty(rate.shape, device=gen.device).exponential_(
        generator=gen)
    return (draws / rate).to(torch_dtype(dtype))


@register("_sample_poisson", needs_rng=True, aliases=("sample_poisson",))
def sample_poisson(lam, shape=(), dtype="float32", generator=None):
    gen, s = _gen(generator, lam), _shape(shape)
    return _poisson(_each(lam, s).contiguous(), gen).to(torch_dtype(dtype))


@register("_sample_negative_binomial", needs_rng=True,
          aliases=("sample_negative_binomial",))
def sample_negative_binomial(k, p, shape=(), dtype="float32",
                             generator=None):
    gen, s = _gen(generator, k), _shape(shape)
    pp = _each(p, s)
    lam = _standard_gamma(_each(k, s).contiguous(), gen) * ((1 - pp) / pp)
    return _poisson(lam, gen).to(torch_dtype(dtype))


@register("_sample_generalized_negative_binomial", needs_rng=True,
          aliases=("sample_generalized_negative_binomial", "sample_gnb"))
def sample_generalized_negative_binomial(mu, alpha, shape=(),
                                         dtype="float32", generator=None):
    gen, s = _gen(generator, mu), _shape(shape)
    a = _each(alpha, s)
    lam = _standard_gamma((1.0 / a).contiguous(), gen) * (a * _each(mu, s))
    return _poisson(lam, gen).to(torch_dtype(dtype))
