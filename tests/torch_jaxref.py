"""Reference values from the JAX package (``src/repro``), computed in a
spawned child process, for the port's tests (``tests/test_torch_*.py``).

Why a child: a pytest worker that has run a jax computation cannot fork
``device_backend="jax"`` stream workers any more (forked children of an
initialised XLA runtime deadlock, and the reference's runtime refuses to
fork), so the reference's own device-stage tests fail when they land on that
worker after a port test.  The port's tests therefore import neither jax nor
the JAX package: every reference value comes from a top-level function of
this module, run by :class:`Reference` in one child started with ``spawn``
(a fresh interpreter that inherits nothing), through a
``ProcessPoolExecutor`` created at the first call and shut down at the end of
the test file (:meth:`Reference.fixture`).

Values cross both ways as numpy arrays and plain Python values; bf16 travels
as ``ml_dtypes.bfloat16`` arrays (``bf16`` makes one from float32).  jax,
jaxlib and ``repro`` are imported only inside the functions below, so only
in the child.  The stream operators (``pair`` and the others) are plain
functions shared by both packages' engines.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest


class Reference:
    """Calls ``name(*args, **kwargs)``, a function of this module, in one
    spawned child; the pool starts at the first call.

    With ``keep=False`` the pool is shut down after every call: for test
    files whose port runs fork workers from this process, which must not
    copy the pool's live threads (its manager and queue feeder) into them.

    With ``host_devices=n`` the child gives jax n CPU devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=n``, set before it
    imports jax), for the reference's sharded runs on a mesh."""

    def __init__(self, keep: bool = True, host_devices: int = 0):
        self._pool = None
        self._keep = keep
        self._host_devices = host_devices

    def submit(self, name: str, *args, **kwargs):
        """Start ``name(*args, **kwargs)`` in the child; returns its future."""
        if self._pool is None:
            self._pool = ProcessPoolExecutor(
                max_workers=1, mp_context=multiprocessing.get_context("spawn"),
                initializer=_child_init, initargs=(self._host_devices,))
        return self._pool.submit(_run, name, args, kwargs)

    def __call__(self, name: str, *args, **kwargs):
        try:
            return self.submit(name, *args, **kwargs).result()
        finally:
            if not self._keep:
                self.close()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def fixture(self):
        """A module-scoped autouse fixture that shuts the child down at the
        end of the test file; assign it to a name in the test module."""
        @pytest.fixture(scope="module", autouse=True)
        def _reference_child():
            yield self
            self.close()
        return _reference_child


def _child_init(host_devices):
    if host_devices:
        import os

        os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={host_devices}"


def _run(name, args, kwargs):
    return globals()[name](*args, **kwargs)


def bf16(x) -> np.ndarray:
    """float32 (or float64) values rounded to bf16, as ``ml_dtypes.bfloat16``."""
    import ml_dtypes

    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _np(tree):
    """jax arrays -> numpy arrays, through dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return np.asarray(tree)


def _jnp_dtype(name: str):
    import jax.numpy as jnp

    return getattr(jnp, name)


# ------------------------------------------------------------ K2 reorder
def reorder_drain(size, width, dtype, batches, payloads, start=0, pallas=False):
    """Commit each of ``batches`` (int32 serials) with its payloads through
    ``commit_ref`` (and the Pallas ``commit_pallas`` in interpret mode with
    ``pallas``) from an empty ring at ``start``.  One dict per commit:
    the reference's emitted, count, accepted and its ring after the commit
    (buf, present, next); with ``pallas`` the Pallas kernel's emitted,
    count, accepted, present and next as ``p_*``."""
    import jax.numpy as jnp
    from repro.kernels.reorder import ops
    from repro.kernels.reorder.ref import commit_ref, init_state

    st = st_p = init_state(size, width, _jnp_dtype(dtype), start=start)
    out = []
    for serials, pay in zip(batches, payloads):
        s, p = jnp.asarray(serials), jnp.asarray(pay)
        st, em, cnt, acc = commit_ref(st, s, p)
        row = dict(emitted=em, count=cnt, accepted=acc, buf=st.buf, present=st.present,
                   next=st.next)
        if pallas:
            st_p, em_p, cnt_p, acc_p = ops.commit(st_p, s, p, use_kernel=True)
            row.update(p_emitted=em_p, p_count=cnt_p, p_accepted=acc_p, p_present=st_p.present,
                       p_next=st_p.next)
        out.append(_np(row))
    return out


# ----------------------------------------------------------- K3 dispatch
def dispatch(ids, payloads, P, C, pallas=False):
    """``dispatch_ref`` (buf, counts, dest), and the Pallas kernel's with
    ``pallas`` (else None)."""
    import jax.numpy as jnp
    from repro.kernels.dispatch import ops
    from repro.kernels.dispatch.ref import dispatch_ref

    jids, jpay = jnp.asarray(ids), jnp.asarray(payloads)
    ref = _np(dispatch_ref(jids, jpay, P, C))
    return ref, (_np(ops.dispatch(jids, jpay, P, C, use_kernel=True)) if pallas else None)


def dispatch_vjp(ids, h, P, C, group, g):
    """``jax.vjp`` of the buffers of ``dispatch_ref`` on the rows of h each
    repeated ``group`` times (``jnp.repeat``: tuple t takes row t // group),
    with respect to h, against the cotangent g (P, C, W)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.dispatch.ref import dispatch_ref

    jids = jnp.asarray(ids)
    _, vjp = jax.vjp(lambda h_: dispatch_ref(jids, jnp.repeat(h_, group, axis=0), P, C)[0],
                     jnp.asarray(h))
    return _np(vjp(jnp.asarray(g))[0])


# ---------------------------------------------------------- K4 attention
def attention(q, k, v, dtype, causal):
    """``attention_ref`` on q, k, v (float32) cast to ``dtype``."""
    from repro.kernels.attention.ref import attention_ref

    jdt = _jnp_dtype(dtype)
    return np.asarray(attention_ref(*(np.asarray(a).astype(jdt) for a in (q, k, v)),
                                    causal=causal))


def attention_vjp(q, k, v, g, causal):
    """``jax.vjp`` of ``attention_ref`` at (q, k, v) against cotangent g, all
    float32: what the reference's ``custom_vjp`` backward returns."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.attention.ref import attention_ref

    _, vjp = jax.vjp(lambda q_, k_, v_: attention_ref(q_, k_, v_, causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    return _np(vjp(jnp.asarray(g)))


# --------------------------------------------------------------- K5 SSD
def ssd(x, dt, A, Bm, Cm, chunk, h0=None, pallas=True, x_dtype="float32"):
    """``ssd_chunked`` (y, hT), and the Pallas ``ops.ssd`` (y, hT) in
    interpret mode with ``pallas`` (else None); x cast to ``x_dtype``."""
    import jax.numpy as jnp
    from repro.kernels.ssd import ops
    from repro.models.ssm import ssd_chunked

    ja = [jnp.asarray(x, _jnp_dtype(x_dtype))] + [jnp.asarray(a) for a in (dt, A, Bm, Cm)]
    ref = None
    if x_dtype == "float32":
        kw = {} if h0 is None else {"h0": jnp.asarray(h0)}
        ref = _np(ssd_chunked(*ja, chunk=chunk, **kw))
    return ref, (_np(ops.ssd(*ja, chunk=chunk)) if pallas else None)


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    import jax.numpy as jnp
    from repro.models.ssm import ssd_decode_step as step

    return _np(step(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h))))


def segsum(a):
    import jax.numpy as jnp
    from repro.models.ssm import segsum as jax_segsum

    return np.asarray(jax_segsum(jnp.asarray(a)))


# ------------------------------------------------ configs and transformer
DTYPE_FIELDS = ("dtype", "param_dtype", "optim_moment_dtype")


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _config(name, smoke, **changes):
    from repro.configs import get_config, smoke_config

    cfg = smoke_config(name) if smoke else get_config(name)
    changes = {k: _jnp_dtype(v) if k in DTYPE_FIELDS else v for k, v in changes.items()}
    return dataclasses.replace(cfg, **changes)


def config_fields(name, smoke, **changes) -> dict:
    """The JAX config (``smoke_config`` or ``get_config``, with ``changes``;
    dtypes by name) as plain values, dtypes by name."""
    cfg = _config(name, smoke, **changes)
    return {f.name: np.dtype(getattr(cfg, f.name)).name if f.name in DTYPE_FIELDS
            else getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def abstract_params(name, smoke):
    """({leaf name: (shape, dtype name)} of ``abstract_params``, ``count_params``)."""
    from repro.models import common

    cfg = _config(name, smoke)
    shapes = {n: (tuple(s.shape), np.dtype(s.dtype).name)
              for n, s in _leaves(common.abstract_params(cfg))}
    return shapes, common.count_params(cfg)


def count_active_params(name, smoke):
    from repro.models import common

    return common.count_active_params(_config(name, smoke))


@functools.lru_cache(maxsize=None)
def _model(dtype, seed, arch="olmo-1b", changes=()):
    """(cfg, params): smoke ``arch`` with dtype and param_dtype ``dtype``
    (None: the smoke config's own) and the field ``changes`` ((name, value)
    pairs), ``init_params`` at PRNGKey(seed)."""
    import jax
    from repro.models import common

    kw = {} if dtype is None else dict(dtype=dtype, param_dtype=dtype)
    cfg = _config(arch, True, **kw, **dict(changes))
    return cfg, common.init_params(cfg, jax.random.PRNGKey(seed))


def _enc(encoder_states):
    import jax.numpy as jnp

    return None if encoder_states is None else jnp.asarray(encoder_states)


def model_params(dtype, seed, arch="olmo-1b"):
    """The parameters of :func:`_model` as a nested dict of numpy arrays."""
    return _np(_model(dtype, seed, arch)[1])


def transformer_outputs(dtype, toks, max_len, arch="olmo-1b", encoder_states=None, **changes):
    """Smoke ``arch`` (PRNGKey(0), with the field ``changes``) on tokens
    (B, S) and ``encoder_states``: ``forward_train`` logits and aux;
    ``prefill`` of all but the last token (logits, cache); ``decode_step`` of
    the last token at position S-1 (logits, new cache).  Caches as {slot:
    {leaf: array}}."""
    import jax.numpy as jnp
    from repro.models import transformer as tf

    cfg, params = _model(dtype, 0, arch, tuple(sorted(changes.items())))
    jt, enc = jnp.asarray(toks), _enc(encoder_states)
    S = toks.shape[1]
    full, aux = tf.forward_train(cfg, params, jt, enc)
    logits_p, cache = tf.prefill(cfg, params, jt[:, : S - 1], enc, max_len=max_len)
    pos = jnp.full((toks.shape[0],), S - 1, jnp.int32)
    logits_d, cache_d = tf.decode_step(cfg, params, jt[:, S - 1], cache, pos)
    return _np(dict(full=full, aux=aux, prefill=logits_p, cache=cache, decode=logits_d,
                    cache_d=cache_d))


def quant_decode(dtype, toks, max_len, arch="olmo-1b"):
    """Smoke ``arch`` (PRNGKey(0)): ``prefill`` of all but the last token,
    its cache made int8 by the reference test's rule
    (``test_serving_optimizations._quantize_cache``), then ``decode_step``
    of the last token with ``kv_quant``: (logits, the new cache)."""
    import jax.numpy as jnp
    from repro.models import transformer as tf
    from test_serving_optimizations import _quantize_cache

    cfg, params = _model(dtype, 0, arch)
    jt, S = jnp.asarray(toks), toks.shape[1]
    _, cache = tf.prefill(cfg, params, jt[:, : S - 1], max_len=max_len)
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    pos = jnp.full((toks.shape[0],), S - 1, jnp.int32)
    return _np(tf.decode_step(cfg_q, params, jt[:, S - 1], _quantize_cache(cache), pos))


def moe_routing(dtype, toks, arch, encoder_states=None):
    """The routing of every MoE layer of smoke ``arch`` (PRNGKey(0)) in
    ``forward_train`` on ``toks``, in the order the layers run: one dict a
    layer with the layer's input ``x`` (B, S, D), the router input ``h``
    (T, D) and the assignments ``ids`` (T*k,), token-major, as the reference
    computed them (recorded with ``jax.debug.callback`` inside its scan)."""
    import jax
    import jax.numpy as jnp
    from repro.models import ffn
    from repro.models import transformer as tf

    cfg, params = _model(dtype, 0, arch)
    seen = []
    norm, rowwise = ffn.apply_norm, ffn.moe_dispatch_rowwise

    def record_h(x, h):
        seen.append({"x": np.asarray(x), "h": np.asarray(h).reshape(-1, h.shape[-1])})

    def record_ids(ids):
        seen[-1]["ids"] = np.asarray(ids).reshape(-1)

    def spy_norm(cfg_, x, p, prefix):
        out = norm(cfg_, x, p, prefix)
        if "w_router" in p:
            jax.debug.callback(record_h, x, out, ordered=True)
        return out

    def spy_rowwise(ids, E, C):
        jax.debug.callback(record_ids, ids, ordered=True)
        return rowwise(ids, E, C)

    ffn.apply_norm, ffn.moe_dispatch_rowwise = spy_norm, spy_rowwise
    try:
        jax.block_until_ready(tf.forward_train(cfg, params, jnp.asarray(toks),
                                               _enc(encoder_states)))
        jax.effects_barrier()
    finally:
        ffn.apply_norm, ffn.moe_dispatch_rowwise = norm, rowwise
    return seen


def generate(dtype, prompt, num_steps, arch="olmo-1b", encoder_states=None):
    import jax.numpy as jnp
    from repro.models import transformer as tf

    cfg, params = _model(dtype, 0, arch)
    return np.asarray(tf.generate(cfg, params, jnp.asarray(prompt), num_steps=num_steps,
                                  encoder_states=_enc(encoder_states)))


def abstract_cache(dtype, batch, max_len, arch="olmo-1b", **changes):
    """[(leaf name, shape, dtype name)] of ``abstract_cache`` of smoke
    ``arch`` in ``dtype`` with the field ``changes``."""
    from repro.models import transformer as tf

    cfg = _config(arch, True, dtype=dtype, param_dtype=dtype, **changes)
    return [(n, tuple(s.shape), np.dtype(s.dtype).name)
            for n, s in _leaves(tf.abstract_cache(cfg, batch, max_len))]


# ----------------------------------------------------------- MoE and mamba2
def _layer(arch, dtype, capacity_factor, p):
    """(cfg, p as jax arrays) for one layer of smoke ``arch``."""
    import jax.numpy as jnp

    changes = dict(dtype=dtype, param_dtype=dtype)
    if capacity_factor is not None:
        changes["capacity_factor"] = capacity_factor
    return _config(arch, True, **changes), {k: jnp.asarray(v) for k, v in p.items()}


def moe_layer(arch, dtype, x, p, capacity_factor=None):
    """The reference ``moe`` on x (B, S, D) with one layer's parameters
    ``p``: (y, aux), and the routing's ``keep`` mask ((B*S*k,), token-major,
    choice minor) from ``moe_dispatch_rowwise``."""
    import math

    import jax
    import jax.numpy as jnp
    from repro.models import ffn
    from repro.models.common import apply_norm

    cfg, jp = _layer(arch, dtype, capacity_factor, p)
    jx = jnp.asarray(x)
    y, aux = ffn.moe(cfg, jp, jx)
    B, S, D = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.top_k
    h = apply_norm(cfg, jx, jp, "ffn_norm").reshape(1, T, D)
    gates = jax.nn.softmax(jnp.einsum("rtd,de->rte", h.astype(jnp.float32), jp["w_router"]), -1)
    _, top_i = jax.lax.top_k(gates, k)
    capacity = max(int(math.ceil(T * k / E * cfg.capacity_factor)), 4)
    _, keep = ffn.moe_dispatch_rowwise(top_i.reshape(1, T * k), E, capacity)
    return _np((y, aux, keep[0]))


def moe_vjp(arch, x, p, g, g_aux, capacity_factor=None):
    """``jax.vjp`` of the reference ``moe`` (f32) at (x, p) against the
    cotangents (g for y, g_aux for aux): (dx, {name: dp})."""
    import jax
    import jax.numpy as jnp
    from repro.models import ffn

    cfg, jp = _layer(arch, "float32", capacity_factor, p)
    _, vjp = jax.vjp(lambda x_, p_: ffn.moe(cfg, p_, x_), jnp.asarray(x), jp)
    return _np(vjp((jnp.asarray(g), jnp.asarray(g_aux, jnp.float32))))


def mamba_layer(arch, dtype, x, p, kind, cache=None):
    """The reference mamba2 block on x with one layer's parameters ``p``:
    ``train`` -> y; ``prefill`` -> (y, ssm state, conv state); ``decode``
    (x (B, 1, D), ``cache`` = (ssm state, conv state)) -> (y, ssm, conv)."""
    import jax.numpy as jnp
    from repro.models import ssm

    cfg, jp = _layer(arch, dtype, None, p)
    jx = jnp.asarray(x)
    if kind == "train":
        return np.asarray(ssm.mamba_train(cfg, jp, jx))
    if kind == "prefill":
        y, (h, conv) = ssm.mamba_prefill(cfg, jp, jx)
    else:
        y, (h, conv) = ssm.mamba_decode(cfg, jp, jx, tuple(jnp.asarray(c) for c in cache))
    return _np((y, h, conv))


def xattn_layer(dtype, x, enc, p, kind, cache=None):
    """The reference cross-attention of smoke llama-3.2-vision with one
    layer's parameters ``p`` on x and encoder states ``enc``: ``train`` ->
    y; ``prefill`` -> (y, ek, ev); ``decode`` (x (B, 1, D), ``cache`` = (ek,
    ev)) -> y."""
    import jax.numpy as jnp
    from repro.models import attention

    cfg, jp = _layer("llama-3.2-vision-90b", dtype, None, p)
    jx = jnp.asarray(x)
    if kind == "train":
        return np.asarray(attention.cross_attn(cfg, jp, jx, jnp.asarray(enc)))
    if kind == "prefill":
        y, (ek, ev) = attention.cross_attn_prefill(cfg, jp, jx, jnp.asarray(enc))
        return _np((y, ek, ev))
    y, _ = attention.cross_attn_decode(cfg, jp, jx, tuple(jnp.asarray(c) for c in cache))
    return np.asarray(y)


def attn_decode_quant(dtype, x, p, cache, position):
    """The reference ``attn_decode_quant`` of smoke olmo-1b with one layer's
    parameters ``p``, on x (B, 1, D) against the int8 ``cache`` ({k, v,
    k_scale, v_scale}) at ``position``: (y, the new cache)."""
    import jax.numpy as jnp
    from repro.models import attention

    cfg, jp = _layer("olmo-1b", dtype, None, p)
    cfg = dataclasses.replace(cfg, kv_quant=True)
    y, new = attention.attn_decode_quant(cfg, jp, jnp.asarray(x),
                                         {k: jnp.asarray(v) for k, v in cache.items()},
                                         jnp.asarray(position))
    return _np((y, new))


def apply_norm(norm_type, x, params, dtype):
    import jax.numpy as jnp
    from repro.models import common

    cfg = _config("olmo-1b", True, norm_type=norm_type)
    return np.asarray(common.apply_norm(cfg, jnp.asarray(x, _jnp_dtype(dtype)),
                                        {k: jnp.asarray(v) for k, v in params.items()}, "n"))


def rope(fraction, x, pos):
    """(cos, sin) of ``rope_freqs`` at ``pos`` and ``apply_rope`` of x."""
    import jax.numpy as jnp
    from repro.models import attention

    cfg = _config("olmo-1b", True, rope_fraction=fraction)
    cos, sin = attention.rope_freqs(cfg, jnp.asarray(pos))
    return _np((cos, sin, attention.apply_rope(jnp.asarray(x), cos, sin)))


def engine_run(seed, requests, schedule, max_slots, max_len, arch="olmo-1b"):
    """The JAX ``OrderedServingEngine`` on smoke ``arch`` in f32
    (PRNGKey(seed)): [(serial, tokens)] in egress order, and its stats."""
    from repro.serve.engine import OrderedServingEngine

    cfg, params = _model("float32", seed, arch)
    eng = OrderedServingEngine(cfg, params, max_slots=max_slots, max_len=max_len,
                               schedule=schedule)
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    comps = eng.run_to_completion()
    return [(c.serial, np.asarray(c.tokens)) for c in comps], dict(eng.stats)


# ------------------------------------------------------ K1 and the stream
def np_affine(x, a, b):
    """The JAX package's NumPy device kernel ``_np_affine`` on one column."""
    from repro.columnar.device import _np_affine

    (out,) = _np_affine((("a", a), ("b", b)))(x)
    return out


def pair(v):
    return [(v, v * 2)]


def mod5(t):
    return t[0] % 5


def zero():
    return 0


def ksum(s, k, t):
    s += t[0]
    return s, [(s, t[1])]


def running(s, t):
    s = (s * 31 + t[0]) % 1000003
    return s, [(t[0], s)]


STREAM_PARAMS = {"a": 3, "b": -1}


def device_chain(pkg_core, pkg_col, code, kernel, backend):
    """``pair`` then one device op on ``kernel``, in either package."""
    schema = pkg_col.Schema.of(code, code)
    return [
        pkg_core.OpSpec("widen2", "stateless", pair, cost_us=1.0),
        pkg_col.device_op("dev", kernel, schema, params=STREAM_PARAMS,
                          backend=backend, cost_us=4.0),
    ]


def keyed_chain(pkg_core, pkg_col=None):
    return [
        pkg_core.OpSpec("widen2", "stateless", pair, cost_us=1.0),
        pkg_core.OpSpec("ksum", "partitioned", ksum, key_fn=mod5, num_partitions=8,
                        init_state=zero, cost_us=2.0),
        pkg_core.OpSpec("run", "stateful", running, init_state=zero, cost_us=2.0),
    ]


def golden_device_chain(pkg_core, pkg_col):
    return [
        pkg_core.OpSpec("pre", "stateless", pair, cost_us=3.0),
        pkg_col.device_op("affine", "affine_pallas", pkg_col.Schema.of("i8", "i8"),
                          params={"a": 3, "b": 1}, cost_us=20.0),
        pkg_core.OpSpec("post", "stateless", pair, cost_us=3.0),
    ]


def run_process(pkg_core, chain, source, backend, batch_size, **proc):
    """``chain`` on ``source`` on the process backend with columnar device
    stages; (outputs, result)."""
    eng = pkg_core.Engine(pkg_core.EngineConfig(
        backend="process", num_workers=2, batch_size=batch_size,
        collect_outputs=True,
        process=pkg_core.ProcessOptions(columnar=True, device_batch=64,
                                        device_backend=backend, **proc),
    ))
    res = eng.run(chain, source)
    return res.handle().outputs, res


def explain(pkg_core, pkg_col, chain_fn, backend):
    kw = {"device_backend": backend} if backend else {}
    eng = pkg_core.Engine(pkg_core.EngineConfig(
        backend="process", num_workers=2, batch_size=32,
        process=pkg_core.ProcessOptions(worker_budget=4, columnar=True,
                                        device_batch=128, **kw),
    ))
    return eng.plan(chain_fn(pkg_core, pkg_col)).explain()


@contextlib.contextmanager
def _own_shm_names():
    """The reference engine's rings get a name apart from ``repro_*``: the
    reference's tests list /dev/shm by that prefix to find leaks, and may
    run at the same time in other workers."""
    from repro.core import procrun

    orig = procrun.shm.ExchangeRing

    def ring(name, *args, **kwargs):
        return orig(name.replace("repro_", "rtorchref_", 1), *args, **kwargs)

    procrun.shm.ExchangeRing = ring
    try:
        yield
    finally:
        procrun.shm.ExchangeRing = orig


def stream_device_egress(source, code, kernel, batch_size):
    """The reference's process-backend egress (``numpy`` device backend) of
    :func:`device_chain`, and its per-value ``ref_apply``, each as ``repr``."""
    import repro.columnar as rcol
    import repro.core as rcore

    with _own_shm_names():
        out, _ = run_process(rcore, device_chain(rcore, rcol, code, kernel, "numpy"), source,
                             "numpy", batch_size)
    frozen = tuple(sorted(STREAM_PARAMS.items()))
    schema = rcol.Schema.of(code, code)
    want = []
    for v in source:
        (t,) = pair(v)
        want.extend(rcol.ref_apply(t, kernel, frozen, schema))
    return repr(out), repr(want)


def stream_device_egress_many(cases):
    """:func:`stream_device_egress` of each (source, code, kernel,
    batch_size) of ``cases``, in one child."""
    return [stream_device_egress(*case) for case in cases]


def stream_keyed(source, backend):
    """The reference's egress of :func:`keyed_chain` on ``backend``."""
    import repro.core as rcore

    eng = rcore.Engine(rcore.EngineConfig(
        backend=backend, num_workers=2, batch_size=7, collect_outputs=True))
    with _own_shm_names():
        return eng.run(keyed_chain(rcore), source).handle().outputs


def stream_explain(chain_name, backend):
    """The reference's ``explain()`` of the named chain of this module."""
    import repro.columnar as rcol
    import repro.core as rcore

    return explain(rcore, rcol, globals()[chain_name], backend)


def stream_launcher_reference(source, device_params, io_batch):
    """The reference's engine on ``launch.stream``'s chain (``widen`` to 12
    ``i8`` columns, then an affine device stage per (a, b), ``numpy``
    backend); its egress."""
    import repro.columnar as rcol
    import repro.core as rcore
    from repro_torch.launch.stream import _widen

    chain = [rcore.OpSpec("widen", "stateless", _widen, cost_us=1.0)] + [
        rcol.device_op(f"dev{i}", "affine_pallas", rcol.Schema.of(*(["i8"] * 12)),
                       params={"a": a, "b": b}, backend="numpy", cost_us=2.0)
        for i, (a, b) in enumerate(device_params)
    ]
    with _own_shm_names():
        out, _ = run_process(rcore, chain, source, "numpy", io_batch)
    return out


# ------------------------------------------ stream workloads and serving tier
def key_sampler(kind, *args):
    """A simulator key sampler, named so that each side builds its own:
    ``("uniform", key_space)`` or ``("gaussian", sigma, key_space)`` (the
    reference test's wrapped normal); ``None`` for none."""
    if kind is None:
        return None
    if kind == "uniform":
        (key_space,) = args

        def uniform(rng):
            return rng.randrange(key_space)

        return uniform
    sigma, key_space = args

    def gaussian(rng):
        v = ((rng.gauss(0.0, sigma) + 1.0) % 2.0) - 1.0
        return int((v + 1.0) / 2.0 * (key_space - 1))

    return gaussian


def tpcxbb_graph(tpcxbb, name, n, seed, dag):
    """``(graph, source list)`` of query ``name`` of the given ``tpcxbb``
    module: its specs, or with ``dag`` its DAG form's ``(nodes, edges)``."""
    if dag:
        nodes, edges, src = tpcxbb.DAG_QUERIES[name](n=n, seed=seed)
        return (nodes, edges), list(src)
    specs, src = tpcxbb.QUERIES[name](n=n, seed=seed)
    return specs, list(src)


def tpcxbb_run(pkg_core, tpcxbb, name, n, seed, dag, backend):
    """The egress of one TPCx-BB query (or DAG form) on ``backend`` of
    either package's Engine."""
    graph, source = tpcxbb_graph(tpcxbb, name, n, seed, dag)
    eng = pkg_core.Engine(pkg_core.EngineConfig(
        backend=backend, num_workers=3, batch_size=8, collect_outputs=True))
    return eng.run(graph, source).outputs


def tpcxbb_egress_many(cases):
    """The reference runtime's egress of each (name, n, seed, dag, backend)
    of ``cases``, as ``repr`` (the values are tuples, lists, ints, floats)."""
    import repro.core as rcore
    from repro.streams import tpcxbb

    with _own_shm_names():
        return [repr(tpcxbb_run(rcore, tpcxbb, *case)) for case in cases]


def tpcxbb_sim_ops(names):
    """The reference's ``sim_ops`` of each query of ``names``, each SimOp as
    a dict."""
    from repro.streams.tpcxbb import sim_ops

    return {name: [dataclasses.asdict(op) for op in sim_ops(name)] for name in names}


def simulate_many(cases):
    """The reference simulator's result dict for each (ops as dicts, or a
    query name for its ``sim_ops``, n_tuples, SimConfig fields, sampler
    spec) of ``cases``."""
    from repro.core.simulate import SimConfig, SimOp, simulate
    from repro.streams.tpcxbb import sim_ops

    out = []
    for ops, n, cfg, sampler in cases:
        ops = sim_ops(ops) if isinstance(ops, str) else [SimOp(**op) for op in ops]
        out.append(simulate(ops, n, SimConfig(**cfg), key_sampler=key_sampler(*sampler)))
    return out


def arrival_times_many(cases):
    """The reference's ``arrival_times`` for each (ArrivalConfig fields, n)."""
    from repro.serve import ArrivalConfig, arrival_times

    return [arrival_times(ArrivalConfig(**cfg), n) for cfg, n in cases]


def analysis_findings(paths, root):
    """The reference's static-analysis findings over ``paths`` (relative to
    ``root``), each as its ``to_dict()``."""
    from repro.analysis import analyze_paths

    return [f.to_dict() for f in analyze_paths(paths, root=root)]


def bench_core_rows(repo, seconds, workers):
    """The keys of the reference's ``device_offload`` and ``serving`` rows of
    ``benchmarks/bench_core.py`` at a window of ``seconds`` (the offload row
    on the NumPy kernel: the keys are the same on every backend)."""
    import sys

    sys.path.insert(0, repo)
    from benchmarks import bench_core

    bench_core._offload_backend = lambda: ("numpy", "affine")
    with _own_shm_names():
        offload = bench_core._run_device_offload(seconds, workers)
    serving = bench_core._run_serving(seconds, workers)
    return {"device_offload": sorted(offload), "serving": sorted(serving)}


# ------------------------------------------------------------------ training
def _ocfg(ocfg):
    """The reference's ``OptConfig`` from a dict of its fields (the moment
    dtype by name)."""
    from repro.train.optimizer import OptConfig

    kw = dict(ocfg)
    if "moment_dtype" in kw:
        kw["moment_dtype"] = _jnp_dtype(kw["moment_dtype"])
    return OptConfig(**kw)


def _tree(tree):
    """Nested dict of numpy arrays -> the same nesting of jax arrays."""
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def opt_schedule(ocfg, steps):
    """``schedule`` at each of ``steps`` (int32), as one f32 array."""
    import jax.numpy as jnp
    from repro.train.optimizer import schedule

    cfg = _ocfg(ocfg)
    return np.asarray([schedule(cfg, jnp.asarray(s, jnp.int32)) for s in steps])


def adamw(ocfg, params, grads, state):
    """One ``apply_adamw`` (op by op, not jitted) on the given trees:
    (params, state, {"lr", "grad_norm"})."""
    from repro.train.optimizer import apply_adamw

    return _np(apply_adamw(_ocfg(ocfg), _tree(params), _tree(grads), _tree(state)))


def loss_grads(dtype, arch, batch):
    """``jax.value_and_grad`` of ``loss_fn`` of smoke ``arch`` (PRNGKey(0)
    params, ``dtype``) on ``batch`` (numpy): (loss, {"nll", "aux"}, grads)."""
    import jax
    from repro.models import transformer as tf

    cfg, params = _model(dtype, 0, arch)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: tf.loss_fn(cfg, p, _tree(batch)), has_aux=True)(params)
    return _np((loss, metrics, grads))


def train_steps(dtype, arch, ocfg, batches):
    """The reference's jitted ``make_train_step`` of smoke ``arch`` from its
    PRNGKey(0) params and ``init_opt_state``, over ``batches``: (each
    step's metrics, the final params, the final optimizer state)."""
    import jax
    from repro.train.optimizer import init_opt_state
    from repro.train.train_step import make_train_step

    cfg, params = _model(dtype, 0, arch)
    oc = _ocfg(ocfg)
    state = init_opt_state(oc, params)
    step = jax.jit(make_train_step(cfg, oc))
    metrics = []
    for b in batches:
        params, state, m = step(params, state, _tree(b))
        metrics.append(_np(m))
    return metrics, _np(params), _np(state)


def checkpoint_save(directory, step, state, extra, keep=3):
    """The reference's ``CheckpointManager(directory, keep).save`` of
    ``state`` (numpy, bf16 as ``ml_dtypes``) as jax arrays; its
    ``all_steps()`` after."""
    from repro.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory, keep=keep)
    mgr.save(step, _tree(state), extra=extra)
    return mgr.all_steps()


def checkpoint_restore(directory, step=None):
    """The reference's ``CheckpointManager(directory).restore(step)``:
    (step, state as numpy, extra)."""
    from repro.train.checkpoint import CheckpointManager

    s, state, extra = CheckpointManager(directory).restore(step)
    return s, _np(state), extra


def quantize(x):
    """The reference's ``_quantize`` of x: (q int8, scale f32)."""
    import jax.numpy as jnp
    from repro.train.grad_compression import _quantize

    return _np(_quantize(jnp.asarray(x)))


# ------------------------------------------------------------------ sharding
def _spec(spec):
    """A ``PartitionSpec`` as a tuple: per dim None, a name or a tuple of names."""
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a for a in spec)


def _specs(tree):
    from jax.sharding import PartitionSpec as P

    if isinstance(tree, P):
        return _spec(tree)
    return {k: _specs(v) for k, v in tree.items()}


def _shapes(tree):
    """A tree of ``ShapeDtypeStruct``s as (shape, dtype name) pairs."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), np.dtype(tree.dtype).name


def spec_trees(arch, mesh_shape, mesh_names, batches, seq_len):
    """The reference's spec trees of the full config of ``arch`` on an
    ``AbstractMesh`` (no devices), as tuples: param and period specs with
    ``fsdp_params`` True and False, cache specs in both modes with and
    without ``kv_quant`` at each of ``batches``, ``batch_spec`` at each of
    ``batches``, and ``sanitize_spec`` of every param leaf."""
    from jax.sharding import AbstractMesh

    from repro.models import common
    from repro.sharding import partitioning as part

    mesh = AbstractMesh(tuple(mesh_shape), tuple(mesh_names))
    out = {}
    for fsdp in (True, False):
        cfg = _config(arch, False, fsdp_params=fsdp)
        out[f"param_pspecs/{fsdp}"] = _specs(common.param_pspecs(cfg))
        out[f"period_pspecs/{fsdp}"] = _specs(common.period_pspecs(cfg))
        out[f"sanitized/{fsdp}"] = {
            n: _spec(part.sanitize_spec(mesh, s, a.shape))
            for (n, s), (_, a) in zip(_leaves_p(common.param_pspecs(cfg)),
                                      _leaves(common.abstract_params(cfg)))}
    for kvq in (False, True):
        cfg = _config(arch, False, kv_quant=kvq)
        for mode in ("decode", "prefill"):
            for b in batches:
                out[f"cache/{kvq}/{mode}/{b}"] = _specs(part.cache_pspecs(cfg, mesh, b, mode))
    for b in batches:
        for extra in (0, 1, 2):
            out[f"batch/{b}/{extra}"] = _spec(part.batch_spec(mesh, b, extra))
    return out


def _leaves_p(tree, prefix=""):
    """(name, spec) pairs of a spec tree, in leaf order."""
    from jax.sharding import PartitionSpec as P

    for k, v in sorted(tree.items()):
        if isinstance(v, P):
            yield f"{prefix}{k}", v
        else:
            yield from _leaves_p(v, f"{prefix}{k}.")


def abstract_trees(arch, batch, seq_len, ocfg):
    """The reference's abstract trees of the full config of ``arch`` as
    (shape, dtype name) pairs: params, period params, the cache and its
    slice, the optimizer state and the train, prefill and serve inputs."""
    from repro.configs.shapes import ShapeSpec
    from repro.models import common, transformer as tf
    from repro.train import optimizer, train_step as ts

    cfg = _config(arch, False)
    oc = _ocfg(ocfg)
    shape = ShapeSpec("t", seq_len, batch, "train")
    ap = common.abstract_params(cfg)
    return _shapes({
        "params": ap, "period": common.abstract_period_params(cfg),
        "cache": tf.abstract_cache(cfg, batch, seq_len),
        "cache_slice": tf.abstract_cache_slice(cfg, batch, seq_len),
        "opt": optimizer.abstract_opt_state(oc, ap),
        "train_batch": ts.abstract_train_batch(cfg, shape),
        "prefill_batch": ts.abstract_prefill_batch(cfg, shape),
        "serve": dict(zip(("cache", "token", "position"), ts.abstract_serve_inputs(cfg, shape))),
    })


def _mesh(shape, names):
    """A mesh of the first prod(shape) host devices with Auto axes
    (``jax.sharding.Mesh``; ``jax.make_mesh`` defaults to Explicit axes, on
    which the reference's sharding constraints raise)."""
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape)), tuple(names))


def sharded_losses(dtype, arch, mesh_shape, mesh_names, toks):
    """``loss_fn`` of smoke ``arch`` (PRNGKey(0) params, ``dtype``) on
    tokens ``toks`` as labels too, jitted on the mesh with the params
    placed by ``param_pspecs`` and the batch by ``batch_spec`` (the
    reference's own recipe, ``tests/test_distribution.py``), and on one
    device: (sharded loss, single-device loss)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.models.common import abstract_params, param_pspecs
    from repro.models.transformer import loss_fn
    from repro.sharding.context import use_mesh
    from repro.sharding.partitioning import batch_spec, named_sanitized

    cfg, params = _model(dtype, 0, arch)
    t = jnp.asarray(toks)
    batch = {"tokens": t, "labels": t}
    mesh = _mesh(mesh_shape, mesh_names)
    with mesh, use_mesh(mesh):
        sp = jax.device_put(params, named_sanitized(mesh, param_pspecs(cfg), abstract_params(cfg)))
        sb = jax.device_put(batch, NamedSharding(mesh, batch_spec(mesh, t.shape[0], 1)))
        sharded, _ = jax.jit(lambda p, b: loss_fn(cfg, p, b))(sp, sb)
    single, _ = loss_fn(cfg, params, batch)
    return float(sharded), float(single)


def sharded_train_step(dtype, arch, ocfg, mesh_shape, mesh_names, batch):
    """One step of the reference's ``make_train_step`` of smoke ``arch``
    from its PRNGKey(0) params and ``init_opt_state``, jitted on the mesh
    with ``train_step_shardings``: (metrics, params after the step)."""
    import dataclasses as dc

    import jax

    from repro.configs.shapes import SHAPES
    from repro.sharding.context import use_mesh
    from repro.train.optimizer import init_opt_state
    from repro.train import train_step as ts

    cfg, params = _model(dtype, 0, arch)
    oc = _ocfg(ocfg)
    state = init_opt_state(oc, params)
    B, S = np.asarray(batch["tokens"]).shape
    shape = dc.replace(SHAPES["train_4k"], seq_len=S, global_batch=B)
    mesh = _mesh(mesh_shape, mesh_names)
    with mesh, use_mesh(mesh):
        ins, outs = ts.train_step_shardings(cfg, oc, mesh, shape)
        step = jax.jit(ts.make_train_step(cfg, oc), in_shardings=ins, out_shardings=outs)
        params, state, metrics = step(params, state, _tree(batch))
    return _np(metrics), _np(params)
