"""Steps of the port captured once as CUDA graphs and replayed.

Counterpart of the JAX package's ``jax.jit``: the JAX package pays its
dispatch once, when it compiles; here a unit of device work (a sampling
call's U-Net eval, or a server's whole call, ``diffusion/graphs.py``; a
train step, ``training/graphs.py``) is captured once per key and every later call with
that key replays it, so the host launches one graph instead of the call's
thousands of kernels.  This module is the machinery both share.

**A ``GraphStore``** holds the captures of a process by key.  A key starts
with the identity of its owner (the U-Net, the train step) and holds
everything else that changes the captured work (each caller's ``key``;
``switches``: the process-wide modes).  A key already captured replays; a
new key captures.

**Weights are read by address.**  A graph holds the addresses of the
tensors it reads.  ``GraphStore.check_weights(owner, stamp(tensors))``
drops every capture of ``owner`` whose tensors changed since they were
made (replaced or moved; with the versions in the stamp, also updated in
place), so a stale address is never replayed: the next call captures anew.
An owner may read several modules (a serving call reads the text encoder,
the U-Net and the autoencoder): its stamp covers them all
(``module_tensors(*modules)``), and so do the derived copies its captures
keep alive (``derived(*modules)``).

**Outputs** are cloned out of the graph's static tensors after each
replay, so a later replay never overwrites what a caller keeps.  The
static inputs are allocated outside the graphs' memory pool; the graphs of
a store share one pool (``torch.cuda.graph_pool_handle``; a new one once
every capture is dropped), which is safe in any replay order because
nothing is read from a graph's static outputs after a later replay.

**Capture discipline.**  The first call of a key runs eagerly on a side
stream (it builds the kernels, makes every plan, and is that call's
result), then the same call is captured and the graph instantiated, so
the first replay costs what every replay does.  A capture or replay that fails
raises: there is no eager fallback on the card.  A capture carries a
``Session``: its hooks around the warm-up and the capture, what it keeps
alive, and what runs after each replay.

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

Graphs run on one CUDA card in a process that is not one rank of several
(``graphs_apply``); the CPU and a mesh of more than one rank run eagerly.
A test can hand a ``GraphStore`` a stand-in for the CUDA graph
(``runner``), which runs the function at capture and again at each replay,
writing into the same static outputs as a replay does; a stand-in has no
kernel nodes, and its replays add the counters' rise during its capture.
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


def switches() -> tuple:
    """The process-wide modes in force that change captured work:
    ``tpu.attention_impl``, the opt-in switches, the TF32 flags and cuDNN's
    benchmark and deterministic flags (which change the kernels cuBLAS and
    cuDNN take)."""
    from ldm_tf2_tpu_torch.ops import attention, fused_conv, group_norm

    return (attention.get_attention_impl(), attention._PACKED_CROSS_ENABLED,
            group_norm.get_groupnorm_impl(), fused_conv.get_fused_conv_impl(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)


# For each wrapper that a U-Net eval or a train step launches, the kernel
# (csrc/*.cu, by its ``__global__`` name) it launches once per counted call,
# by the path its C entry reports (None: the same kernel on every path or
# plan mode)
_KERNELS = {
    "flash_attention": {"wgmma": "flash_fwd_wgmma_kernel", "mma.sync": "flash_fwd_mma_kernel",
                        "fma": "flash_fwd_kernel"},
    "flash_backward_dq": {"wgmma": "flash_bwd_dq_wgmma_kernel",
                          "mma.sync": "flash_bwd_dq_mma_kernel", "fma": "flash_bwd_dq_kernel"},
    "flash_backward_dkv": {"wgmma": "flash_bwd_dkv_wgmma_kernel",
                           "mma.sync": "flash_bwd_dkv_mma_kernel", "fma": "flash_bwd_dkv_kernel"},
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


def backed_rise(host: dict, kernels: dict, relayouts: bool = False) -> dict:
    """The counters' rise per replay of a graph whose kernel nodes are
    ``kernels`` ({name: nodes}, ``graph_kernels``) and whose capture moved
    the counters by ``host`` (a ``rise``): each wrapper's launches and
    launches by path counted off the nodes (``_KERNELS``), a plan's modes
    and the ``_SUBSETS`` counters taken from ``host`` within the launches the
    nodes give.  Raises where ``host`` and the nodes disagree: a counted
    launch the graph does not hold, a kernel of the port in the graph that no
    counter counted, a counter no node backs (a relayout inside a capture,
    unless ``relayouts``: a train step's capture relays the weight of each
    wgmma conv launch, ``ops.fused_conv.relayout_inside``)."""
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
        elif relayouts and (name, attr) == ("gn_silu_conv3x3_fused", "relayouts"):
            within = value == out.get((fn, "launches_by_path"), {}).get("wgmma", 0)
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


def module_tensors(*modules) -> list:
    """The parameters and buffers of ``modules``, in order."""
    return list(itertools.chain.from_iterable(
        itertools.chain(m.parameters(), m.buffers()) for m in modules))


def stamp(tensors, versions: bool = True) -> tuple:
    """Each tensor's identity, address and (with ``versions``) version (an
    inference tensor has no version counter), for ``check_weights``."""
    return tuple((id(t), t.data_ptr(),
                  None if not versions or t.is_inference() else t._version)
                 for t in tensors)


def derived(*modules) -> list:
    """The copies a capture reads that are derived from the weights of
    ``modules`` and cached outside them: the fused conv's relaid weights of
    their parameters, and the GroupNorm statistics workspaces.  A capture
    keeps them alive."""
    from ldm_tf2_tpu_torch.ops import fused_conv, group_norm

    mine = {id(p) for module in modules for p in module.parameters()}
    held = [hit[3] for key, hit in list(fused_conv._RELAID.items()) if key in mine]
    for pair in list(group_norm._WORKSPACES.values()):
        held.extend(t for t in pair if t is not None)
    return held


class Session:
    """What a capture carries besides its graph, and its hooks; this one
    adds nothing, as a sampling eval needs.  ``modules``: those whose
    derived copies the capture keeps alive (``derived``; none: only the
    GroupNorm workspaces), held by weak references so that a capture never
    keeps its owner alive.  ``relayouts``: whether the capture relays conv
    weights inside it (``backed_rise``)."""

    relayouts = False

    def __init__(self, *modules):
        self._modules = [weakref.ref(m) for m in modules]

    def warmup(self, fn):
        """``fn`` as the eager warm-up runs it."""
        return fn

    def capture(self, fn):
        """``fn`` as the capture runs it."""
        return fn

    def prepare(self, runner) -> None:
        """Runs between the warm-up and the capture."""

    def held(self) -> list:
        """The tensors outside the graph that it reads and keeps alive."""
        return derived(*(m for m in (ref() for ref in self._modules) if m is not None))

    def after_replay(self) -> None:
        """Runs after each replay."""


class CUDAGraphRunner:
    """One ``torch.cuda.CUDAGraph`` in the store's memory pool: an eager
    warm-up on a side stream, one capture, instantiated at once (a graph
    kept for its nodes is otherwise instantiated at its first replay, which
    would then pay for it: over a second for a serving call's 100,000
    nodes), its kernel nodes, replays on the current stream."""

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
        self.graph.instantiate()
        return out

    def register_generators(self, generators) -> None:
        """Register generators the capture draws from with the graph: each
        replay then reads the state the host set them to."""
        for gen in generators:
            self.graph.register_generator_state(gen)

    def kernels(self) -> collections.Counter:
        return graph_kernels(self.graph)

    def replay(self) -> None:
        self.graph.replay()


class _Capture:
    __slots__ = ("runner", "inputs", "outputs", "rise", "kernels", "held", "session")

    def __init__(self, runner, inputs, outputs, rise, kernels, held, session):
        self.runner, self.inputs, self.outputs = runner, inputs, outputs
        self.rise, self.kernels, self.held = rise, kernels, held
        self.session = session


class GraphStore:
    """The captures of a process, by key (the module docstring).
    ``runner``: a callable that returns a new runner (``warmup(fn)``,
    ``capture(fn)``, ``register_generators(gens)``, ``kernels()``: the
    graph's kernel nodes by name, or None for a stand-in, ``replay()``);
    None: ``CUDAGraphRunner`` in one memory pool shared by the store's
    graphs.  ``capture_seconds`` lists the seconds of each capture made,
    dropped ones included (its eager warm-up included), and ``replays``
    counts the replays made."""

    def __init__(self, runner=None):
        self._runner = runner
        self._pool = None
        self._entries: dict = {}
        self._stamps: dict = {}  # id(owner) -> its stamp
        self.capture_seconds: list = []
        self.replays = 0

    def __len__(self) -> int:
        return len(self._entries)

    def kernels(self, key) -> collections.Counter | None:
        """The kernel nodes by name of ``key``'s capture, which each replay
        launches (None for a stand-in's)."""
        return self._entries[key].kernels

    def session(self, key) -> Session | None:
        """The session ``key``'s capture was made with (``run``), or None
        where ``key`` has no capture."""
        cap = self._entries.get(key)
        return None if cap is None else cap.session

    def clear(self) -> None:
        """Drop every capture (their graphs and pool memory with them)."""
        self._entries.clear()
        self._stamps.clear()

    def _forget(self, owner_id: int) -> None:
        for key in [k for k in self._entries if k[0] == owner_id]:
            del self._entries[key]

    def check_weights(self, owner, stamped: tuple) -> None:
        """Drop ``owner``'s captures (those whose key starts with its id)
        where ``stamped`` (a ``stamp`` of the tensors they read) changed
        since they were made."""
        uid = id(owner)
        known = self._stamps.get(uid)
        if known == stamped:
            return
        if known is None:
            weakref.finalize(owner, self._drop_owner, uid)
        self._forget(uid)
        self._stamps[uid] = stamped

    def _drop_owner(self, uid: int) -> None:
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

    def run(self, key, fn, inputs, session: Session):
        """One call of ``fn(*static_inputs) -> tuple of outputs``: a replay
        of ``key``'s capture, or, for a new key, the eager warm-up (this
        call's result) and the capture, which keeps ``session``.  Returns a
        tuple of tensors no later replay writes."""
        cap = self._entries.get(key)
        if cap is None:
            return self._capture(key, fn, inputs, session)
        for static, value in zip(cap.inputs, inputs):
            static.copy_(value)
        cap.runner.replay()
        self.replays += 1
        add_counts(cap.rise)
        cap.session.after_replay()
        return tuple(out.clone() for out in cap.outputs)

    def _capture(self, key, fn, inputs, session):
        start = time.perf_counter()
        static = tuple(value.clone() for value in inputs)
        runner = self._new_runner()
        warm, capt = session.warmup(fn), session.capture(fn)
        result = runner.warmup(lambda: warm(*static))
        session.prepare(runner)
        before = counts()
        outputs = runner.capture(lambda: capt(*static))
        moved = rise(before, counts())
        add_counts(moved, -1)  # the capture launched nothing
        kernels = runner.kernels()
        per_replay = (moved if kernels is None
                      else backed_rise(moved, kernels, session.relayouts))
        self._entries[key] = _Capture(runner, static, outputs, per_replay, kernels,
                                      session.held(), session)
        self.capture_seconds.append(time.perf_counter() - start)
        return result


def distributed_world() -> int:
    """The ranks of the default process group (1 when there is none)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def graphs_apply(device) -> bool:
    """Whether a call on ``device`` replays graphs: on a CUDA device in a
    process that is not one rank of several."""
    return torch.device(device).type == "cuda" and distributed_world() == 1


def describe(device, graphs: bool = True, what: str = "U-Net evals") -> str:
    """How a call's ``what`` (a sampling call's U-Net evals, a trainer's
    steps) run, for the entry points' logs."""
    if graphs and graphs_apply(device):
        return f"{what} captured as CUDA graphs (one per shape key) and replayed"
    if not graphs:
        return f"{what} run eagerly (graphs=False)"
    if torch.device(device).type != "cuda":
        return f"{what} run eagerly (no CUDA graphs on the CPU)"
    return (f"{what} run eagerly: a mesh of {distributed_world()} ranks (CUDA "
            "graphs run on one rank only)")
