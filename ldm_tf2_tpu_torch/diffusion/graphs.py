"""The sampling loops' U-Net eval, captured once as a CUDA graph and replayed.

Counterpart of the JAX package's compiled sampling program: its
``jax.jit`` of the pipeline (``cli/run_ldm_sampler.py``, the server's
warm-up compile), the ``lax.scan`` of every loop and the server's
``--aot_cache``.  The JAX package pays its dispatch once, when it
compiles; here one U-Net eval is captured once per shape key (at the
server's warm-up, or at a call's first eval) and every later eval with
that key replays it, so the host launches one graph instead of the
eval's thousands of kernels.  The loops themselves stay Python
(``diffusion/sampler.py``, ``diffusion/solvers.py``): they call the
graphed model as they call the U-Net.

``graphed_eps_model(unet)`` is that model: ``(x2 [2B, h, w, c], t [2B],
context [2B, S, D]) -> eps``, and the DeepCache variants of the U-Net's
own signature (``return_cache=True`` -> ``(eps, cache)``,
``shallow_cache=cache``, ``cache_levels``).  ``eps_model_for`` picks it or
the eager U-Net for a sampling call.

**A capture's key** is everything that changes the captured work: the
U-Net's identity and compute dtype, the variant and ``cache_levels``, every
input's shape, dtype and device, and the modes in force (``unet``'s int8
serving modes, ``tpu.attention_impl``, the opt-in switches of
``ops.group_norm``, ``ops.fused_conv`` and ``ops.attention``, the TF32
flags, cuDNN's benchmark and deterministic flags).  A key already
captured replays; a new key captures.

**Weights are read by address.**  A graph holds the addresses of the
U-Net's parameters and buffers (the int8 weights ``set_serving_modes``
derives among them) and of the copies derived from them on the way (the
fused conv's relaid weights, ``ops.fused_conv.relaid_weight``; the
GroupNorm statistics workspace), and keeps those copies alive.  So a U-Net
whose tensors were replaced, or updated in place, since a capture has
every capture of it **dropped**, never replayed: the next eval captures
anew.  The full check (every tensor's identity, address and version) runs
when ``graphed_eps_model`` is called, once a sampling call; every eval
checks the versions of the tensors it found then.  An inference tensor
(one made under ``torch.inference_mode``) has no version, so only its
replacement is seen: update such a weight by replacing it.

**Outputs** are cloned out of the graph's static tensors after each
replay, so a later replay never overwrites what a loop keeps (PLMS's eps
history, DPM-Solver++(2M)'s ``x0_last``, DeepCache's cache).  The static
inputs are allocated outside the graphs' memory pool; the graphs of a
process share one pool (``torch.cuda.graph_pool_handle``; a new one once
every capture is dropped), which is safe in any replay order because
nothing is read from a graph's static outputs after a later replay.

**Capture discipline.**  The first eval of a key runs eagerly on a side
stream (it builds the kernels, makes every plan and relayout, and is that
eval's result, counted as an eager eval), then the same eval is captured
under ``torch.inference_mode``.  A capture or replay that fails raises:
there is no eager fallback on the card.

**Launch counts.**  The kernel wrappers' host counters (``launches``,
``launches_by_path`` and the like, on the wrappers of ``_wrappers``) tick
while their kernels are captured, not while a graph replays.  A capture
reads its graph's kernel nodes by name (``graph_kernels``: each node is one
launch that every replay makes) and counts, off those nodes, each wrapper's
launches by path (``backed_rise``: one node of the wrapper's kernel per
counted call, ``_KERNELS``).  Those counts must equal the counters' rise
during the capture, or the capture raises; the counters' rise is then taken
back (the capture ran nothing) and every replay adds the node counts.  So a
graphed call counts what the eager call counts, and each count is a kernel
in the graph that replays.

On the CPU there is no graph: ``eps_model_for`` returns the U-Net itself.
Nor on a mesh of more than one rank (tensor, sequence or data parallelism
over ``torch.distributed``): those calls run eagerly.  A test can hand a
``GraphStore`` a stand-in for the CUDA graph (``runner``), which runs the
function at capture and again at each replay, writing into the same static
outputs as a replay does; a stand-in has no kernel nodes, and its replays
add the counters' rise during its capture.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import time
import weakref

import torch


def _wrappers():
    """The kernel wrappers whose host counters a replay must tick."""
    from ldm_tf2_tpu_torch.ops import cross_attention as ca
    from ldm_tf2_tpu_torch.ops import flash_attention as fa
    from ldm_tf2_tpu_torch.ops import fused_conv as fc
    from ldm_tf2_tpu_torch.ops import fused_ffn as ff
    from ldm_tf2_tpu_torch.ops import group_norm as gn
    from ldm_tf2_tpu_torch.ops import quant_conv as qc

    return (fa.flash_attention, fa.flash_attention_pv_int8, fa.flash_backward_dq,
            fa.flash_backward_dkv, ff.fused_ffn, ff.fused_ffn_int8,
            fc.gn_silu_conv3x3_fused, ca.cross_attention, gn.group_stats,
            gn.group_norm_fused, qc.gn_silu_quant, qc.s8_conv3x3,
            qc.gn_silu_conv3x3_int8)


def counts() -> dict:
    """Every wrapper counter's value, {(wrapper, attribute): int or dict}:
    each attribute of a wrapper that is an int or a dict of ints."""
    out = {}
    for fn in _wrappers():
        for attr, value in vars(fn).items():
            if isinstance(value, int):
                out[(fn, attr)] = value
            elif isinstance(value, dict):
                out[(fn, attr)] = dict(value)
    return out


def rise(before: dict, after: dict) -> dict:
    """The counters that moved from ``before`` to ``after``, by how much."""
    out = {}
    for key, now in after.items():
        then = before.get(key)
        if isinstance(now, int):
            if now != (then or 0):
                out[key] = now - (then or 0)
        else:
            moved = {k: n - (then or {}).get(k, 0) for k, n in now.items()
                     if n != (then or {}).get(k, 0)}
            if moved:
                out[key] = moved
    return out


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a ``rise``) to the counters, each read
    afresh (a caller may have replaced a counter's dict)."""
    for (fn, attr), d in delta.items():
        value = getattr(fn, attr)
        if isinstance(d, int):
            setattr(fn, attr, value + sign * d)
        else:
            for k, n in d.items():
                value[k] = value.get(k, 0) + sign * n


def modes(unet) -> tuple:
    """The modes in force that change a U-Net eval's captured work (the
    TF32 flags and cuDNN's benchmark and deterministic flags change which
    kernels cuBLAS and cuDNN take)."""
    from ldm_tf2_tpu_torch.ops import attention, fused_conv, group_norm

    return (unet.dtype, unet.conv_quant, unet.attention_pv_int8,
            attention.get_attention_impl(), attention._PACKED_CROSS_ENABLED,
            group_norm.get_groupnorm_impl(), fused_conv.get_fused_conv_impl(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)


# For each wrapper that a U-Net eval launches, the kernel (csrc/*.cu, by its
# ``__global__`` name) it launches once per counted call, by the path its C
# entry reports (None: the same kernel on every path or plan mode)
_KERNELS = {
    "flash_attention": {"wgmma": "flash_fwd_wgmma_kernel", "mma.sync": "flash_fwd_mma_kernel",
                        "fma": "flash_fwd_kernel"},
    "flash_attention_pv_int8": {"wgmma": "pv_int8_wgmma_kernel",
                                "mma.sync": "pv_int8_mma_kernel", "fma": "pv_int8_fma_kernel"},
    "fused_ffn": {"wgmma": "ffn_down_kernel", "fma": "ffn_kernel"},
    "gn_silu_conv3x3_fused": {"wgmma": "conv_wgmma_kernel", "mma.sync": "conv_mma_kernel",
                              "fma": "conv_fma_kernel"},
    "cross_attention": {"wgmma": "cross_wgmma_kernel", "mma.sync": "cross_mma_kernel",
                        "fma": "cross_fma_kernel"},
    "group_norm_fused": {None: "gn_cluster_norm_kernel"},
    "gn_silu_quant": {None: "gn_silu_quant_cluster_kernel"},
    "s8_conv3x3": {"wgmma": "s8_conv_wgmma_kernel"},
    # after the fused conv: its chains run this kernel as their first stage
    "group_stats": {None: "gn_channel_stats_kernel"},
}
# Counters that pick out, by a host decision (the shapes where the TPU streams
# or runs its whole int8 chain), some of the launches of the wrappers named:
# each is at most their launches
_SUBSETS = {("gn_silu_quant", "stream_launches"): ("gn_silu_quant",),
            ("gn_silu_conv3x3_int8", "launches"): ("gn_silu_quant", "s8_conv3x3")}


def kernel_base_name(name: str) -> str:
    """A kernel's unqualified name from its (Itanium-mangled) symbol:
    ``_ZN12_GLOBAL__N_117conv_wgmma_kernelI...`` -> ``conv_wgmma_kernel``;
    a name that is not mangled is its own."""
    nested = name.startswith("_ZN")
    i = 3 if nested else 2
    if not name.startswith("_Z"):
        return name
    base = name
    while True:
        while i < len(name) and name[i] == "L":
            i += 1
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        if j == i:
            return base
        base, i = name[j:j + int(name[i:j])], j + int(name[i:j])
        if not nested:
            return base


def backed_rise(host: dict, kernels: dict) -> dict:
    """The counters' rise per replay of a graph whose kernel nodes are
    ``kernels`` ({name: nodes}, ``graph_kernels``) and whose capture moved
    the counters by ``host`` (a ``rise``): each wrapper's launches and
    launches by path counted off the nodes (``_KERNELS``), a plan's modes
    and the ``_SUBSETS`` counters taken from ``host`` within the launches the
    nodes give.  Raises where ``host`` and the nodes disagree: a counted
    launch the graph does not hold, a kernel of the port in the graph that no
    counter counted, a counter no node backs (a relayout inside a capture)."""
    fns = {fn.__name__: fn for fn in _wrappers()}
    nodes = collections.Counter()
    for name, n in kernels.items():
        nodes[kernel_base_name(name)] += n
    out, launches = {}, {}
    for wname, paths in _KERNELS.items():
        fn = fns[wname]
        by_path = {p: nodes[k] for p, k in paths.items() if nodes[k]}
        total = sum(by_path.values())
        if wname == "group_stats":
            total -= launches["gn_silu_conv3x3_fused"]
        launches[wname] = total
        if total:
            out[(fn, "launches")] = total
        if None not in paths and by_path:
            out[(fn, "launches_by_path")] = by_path
    wrong = [f"{fn.__name__}.{attr} counted {host.get((fn, attr))}, the graph holds "
             f"{value}" for (fn, attr), value in out.items() if host.get((fn, attr)) != value]
    for (fn, attr), value in host.items():
        name = fn.__name__
        if (fn, attr) in out:
            continue
        if attr == "launches_by_path" and None in _KERNELS.get(name, {}):
            within = sum(value.values()) == launches[name]  # a plan's modes
        elif (name, attr) in _SUBSETS:
            within = value <= min(launches[w] for w in _SUBSETS[name, attr])
        else:
            within = False
        if not within:
            wrong.append(f"{name}.{attr} counted {value}, which the graph's kernels do not back")
        out[(fn, attr)] = value
    if wrong:
        raise RuntimeError("a capture's launch counts disagree with its graph: "
                           + "; ".join(wrong))
    return out


class _KernelNodeParams(ctypes.Structure):
    """libcuda's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), *((d, ctypes.c_uint) for d in (
                    "grid_x", "grid_y", "grid_z", "block_x", "block_y", "block_z", "smem")),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(graph) -> collections.Counter:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``, by kernel name (each node is one launch that every
    replay makes), read with libcuda's graph API."""
    lib = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(lib, fn)(*args)
        if err:
            raise RuntimeError(f"{fn} failed: CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    names = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == 6:  # CU_GRAPH_NODE_TYPE_GRAPH: torch's capture makes none
            raise RuntimeError("a captured graph holds a child graph")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
        func = ctypes.c_void_p(params.func)
        if not params.func:
            call("cuKernelGetFunction", ctypes.byref(func), ctypes.c_void_p(params.kern))
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name), func)
        names[name.value.decode()] += 1
    return names


def _tensors(unet) -> list:
    return list(itertools.chain(unet.parameters(), unet.buffers()))


def _stamp(tensors) -> tuple:
    """Each tensor's identity, address and version (an inference tensor
    has no version counter)."""
    return tuple((id(t), t.data_ptr(), None if t.is_inference() else t._version)
                 for t in tensors)


def _derived(unet) -> list:
    """The copies a U-Net eval reads that are derived from its weights and
    cached outside it: the fused conv's relaid weights of this U-Net, and
    the GroupNorm statistics workspaces.  A capture keeps them alive."""
    from ldm_tf2_tpu_torch.ops import fused_conv, group_norm

    mine = {id(p) for p in unet.parameters()}
    held = [hit[3] for key, hit in list(fused_conv._RELAID.items()) if key in mine]
    for pair in list(group_norm._WORKSPACES.values()):
        held.extend(t for t in pair if t is not None)
    return held


class CUDAGraphRunner:
    """One ``torch.cuda.CUDAGraph`` in the store's memory pool: an eager
    warm-up on a side stream, one capture, its kernel nodes, replays on the
    current stream."""

    def __init__(self, pool):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.pool = pool

    def warmup(self, fn):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def capture(self, fn):
        with torch.cuda.graph(self.graph, pool=self.pool):
            out = fn()
        return out

    def kernels(self) -> collections.Counter:
        return graph_kernels(self.graph)

    def replay(self) -> None:
        self.graph.replay()


class _Capture:
    __slots__ = ("runner", "inputs", "outputs", "rise", "kernels", "held")

    def __init__(self, runner, inputs, outputs, rise, kernels, held):
        self.runner, self.inputs, self.outputs = runner, inputs, outputs
        self.rise, self.kernels, self.held = rise, kernels, held


class GraphStore:
    """The captures of a process, by key (the module docstring).
    ``runner``: a callable that returns a new runner (``warmup(fn)``,
    ``capture(fn)``, ``kernels()``: the graph's kernel nodes by name, or
    None for a stand-in, ``replay()``); None: ``CUDAGraphRunner`` in one
    memory pool shared by the store's graphs.  ``capture_seconds`` lists the
    seconds of each capture made, dropped ones included (its eager warm-up
    included)."""

    def __init__(self, runner=None):
        self._runner = runner
        self._pool = None
        self._entries: dict = {}
        self._stamps: dict = {}  # id(unet) -> _stamp of its tensors
        self.capture_seconds: list = []

    def __len__(self) -> int:
        return len(self._entries)

    def kernels(self, key) -> collections.Counter | None:
        """The kernel nodes by name of ``key``'s capture, which each replay
        launches (None for a stand-in's)."""
        return self._entries[key].kernels

    def clear(self) -> None:
        """Drop every capture (their graphs and pool memory with them)."""
        self._entries.clear()
        self._stamps.clear()

    def _forget(self, unet_id: int) -> None:
        for key in [k for k in self._entries if k[0] == unet_id]:
            del self._entries[key]

    def check_weights(self, unet, tensors) -> None:
        """Drop ``unet``'s captures where its tensors changed since they
        were made (replaced, moved or updated in place)."""
        stamp = _stamp(tensors)
        uid = id(unet)
        known = self._stamps.get(uid)
        if known == stamp:
            return
        if known is None:
            weakref.finalize(unet, self._drop_unet, uid)
        self._forget(uid)
        self._stamps[uid] = stamp

    def _drop_unet(self, uid: int) -> None:
        self._forget(uid)
        self._stamps.pop(uid, None)

    def _new_runner(self):
        if self._runner is not None:
            return self._runner()
        if self._pool is None or not self._entries:
            # a pool whose graphs are all gone may not take a new capture:
            # PyTorch frees it once its last graph is deleted
            self._pool = torch.cuda.graph_pool_handle()
        return CUDAGraphRunner(self._pool)

    def run(self, key, fn, inputs, unet):
        """One eval of ``fn(*static_inputs) -> tuple of outputs``: a replay
        of ``key``'s capture, or, for a new key, the eager warm-up (this
        eval's result) and the capture.  Returns a tuple of tensors no later
        replay writes."""
        cap = self._entries.get(key)
        if cap is None:
            return self._capture(key, fn, inputs, unet)
        for static, value in zip(cap.inputs, inputs):
            static.copy_(value)
        cap.runner.replay()
        add_counts(cap.rise)
        return tuple(out.clone() for out in cap.outputs)

    def _capture(self, key, fn, inputs, unet):
        start = time.perf_counter()
        static = tuple(value.clone() for value in inputs)
        runner = self._new_runner()
        result = runner.warmup(lambda: fn(*static))
        before = counts()
        outputs = runner.capture(lambda: fn(*static))
        moved = rise(before, counts())
        add_counts(moved, -1)  # the capture launched nothing
        kernels = runner.kernels()
        per_replay = moved if kernels is None else backed_rise(moved, kernels)
        self._entries[key] = _Capture(runner, static, outputs, per_replay, kernels,
                                      _derived(unet))
        self.capture_seconds.append(time.perf_counter() - start)
        return result


STORE = GraphStore()


class GraphedEps:
    """A U-Net's evals through ``store`` (``graphed_eps_model``)."""

    def __init__(self, unet, store: GraphStore):
        self.unet, self.store = unet, store
        self._tensors = _tensors(unet)
        store.check_weights(unet, self._tensors)
        self._tracked = [t for t in self._tensors if not t.is_inference()]
        self._versions = [t._version for t in self._tracked]

    def _check_versions(self) -> None:
        versions = [t._version for t in self._tracked]
        if versions != self._versions:
            self.store.check_weights(self.unet, self._tensors)
            self._versions = versions

    def key(self, x, t, context, *, return_cache: bool = False, shallow_cache=None,
            cache_levels: int = 1) -> tuple:
        """The key of a capture of this eval (the module docstring)."""
        shallow = shallow_cache is not None
        variant = "shallow" if shallow else "cache" if return_cache else "full"
        inputs = (x, t, context) + ((shallow_cache,) if shallow else ())
        return (id(self.unet), variant, None if variant == "full" else int(cache_levels),
                tuple((tuple(v.shape), v.dtype, v.device) for v in inputs), modes(self.unet))

    def __call__(self, x, t, context, *, return_cache: bool = False,
                 shallow_cache=None, cache_levels: int = 1):
        unet = self.unet
        self._check_versions()
        inputs = (x, t, context) + (() if shallow_cache is None else (shallow_cache,))
        key = self.key(x, t, context, return_cache=return_cache, shallow_cache=shallow_cache,
                       cache_levels=cache_levels)

        def fn(x, t, context, cache=None):
            out = unet(x, t, context, return_cache=return_cache, shallow_cache=cache,
                       cache_levels=cache_levels)
            return out if return_cache else (out,)

        with torch.inference_mode():
            out = self.store.run(key, fn, inputs, unet)
        return out if return_cache else out[0]


def graphed_eps_model(unet, store: GraphStore | None = None) -> GraphedEps:
    """``unet``'s evals captured and replayed through ``store`` (the
    process's ``STORE`` when None): a drop-in for the U-Net in the sampling
    loops, DeepCache's calls included.  Checks ``unet``'s tensors against
    its captures first (the module docstring)."""
    return GraphedEps(unet, STORE if store is None else store)


def distributed_world() -> int:
    """The ranks of the default process group (1 when there is none)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def graphs_apply(device) -> bool:
    """Whether a sampling call on ``device`` replays graphs: on a CUDA
    device in a process that is not one rank of several."""
    return torch.device(device).type == "cuda" and distributed_world() == 1


def eps_model_for(unet, device, graphs: bool = True):
    """The model a sampling call hands its loop: ``graphed_eps_model(unet)``
    where ``graphs`` and ``graphs_apply(device)``, else ``unet`` itself."""
    if graphs and graphs_apply(device):
        return graphed_eps_model(unet)
    return unet


def describe(device, graphs: bool = True) -> str:
    """How a sampling call's U-Net evals run, for the entry points' logs."""
    if graphs and graphs_apply(device):
        return "U-Net evals captured as CUDA graphs (one per shape key) and replayed"
    if not graphs:
        return "U-Net evals run eagerly (graphs=False)"
    if torch.device(device).type != "cuda":
        return "U-Net evals run eagerly (no CUDA graphs on the CPU)"
    return (f"U-Net evals run eagerly: a mesh of {distributed_world()} ranks (CUDA "
            "graphs run on one rank only)")
