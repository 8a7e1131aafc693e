"""The sampling loops' U-Net eval, captured once as a CUDA graph and replayed.

Counterpart of the JAX package's compiled sampling program: its
``jax.jit`` of the pipeline (``cli/run_ldm_sampler.py``, the server's
warm-up compile), the ``lax.scan`` of every loop and the server's
``--aot_cache``.  One U-Net eval is captured once per shape key (at the
server's warm-up, or at a call's first eval) and every later eval with
that key replays it, through the store of ``ldm_tf2_tpu_torch/graphs.py``
(the machinery the train steps' graphs share: keys, weights by address,
cloned outputs, the pool, launch counts off the graph's kernel nodes).
The loops themselves stay Python (``diffusion/sampler.py``,
``diffusion/solvers.py``): they call the graphed model as they call the
U-Net.

``graphed_eps_model(unet)`` is that model: ``(x2 [2B, h, w, c], t [2B],
context [2B, S, D]) -> eps``, and the DeepCache variants of the U-Net's
own signature (``return_cache=True`` -> ``(eps, cache)``,
``shallow_cache=cache``, ``cache_levels``).  ``eps_model_for`` picks it or
the eager U-Net for a sampling call.

**A capture's key** is everything that changes the captured work: the
U-Net's identity and compute dtype, the variant and ``cache_levels``, every
input's shape, dtype and device, and the modes in force (``unet``'s int8
serving modes, and the process's ``switches``: ``tpu.attention_impl``,
the opt-in switches of ``ops.group_norm``, ``ops.fused_conv`` and
``ops.attention``, the TF32 flags, cuDNN's benchmark and deterministic
flags).  A key already captured replays; a new key captures.

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
replacement is seen: update such a weight by replacing it.  A graphed
train step bumps the versions of what it updates, so a sampling call
after it captures anew.

**Outputs** are cloned out of the graph after each replay, so a later
replay never overwrites what a loop keeps (PLMS's eps history,
DPM-Solver++(2M)'s ``x0_last``, DeepCache's cache).  The first eval of a
key runs eagerly (counted as an eager eval), then the same eval is
captured under ``torch.inference_mode``.

On the CPU there is no graph: ``eps_model_for`` returns the U-Net itself.
Nor on a mesh of more than one rank (tensor, sequence or data parallelism
over ``torch.distributed``): those calls run eagerly.
"""

from __future__ import annotations

import torch

from ldm_tf2_tpu_torch.graphs import (
    GraphStore, Session, graphs_apply, module_tensors, stamp, switches,
)


def modes(unet) -> tuple:
    """The modes in force that change a U-Net eval's captured work: its
    compute dtype and int8 serving modes, and the ``switches``."""
    return (unet.dtype, unet.conv_quant, unet.attention_pv_int8) + switches()


STORE = GraphStore()


class GraphedEps:
    """A U-Net's evals through ``store`` (``graphed_eps_model``)."""

    def __init__(self, unet, store: GraphStore):
        self.unet, self.store = unet, store
        self._tensors = module_tensors(unet)
        self._session = Session(unet)
        store.check_weights(unet, stamp(self._tensors))
        self._tracked = [t for t in self._tensors if not t.is_inference()]
        self._versions = [t._version for t in self._tracked]

    def _check_versions(self) -> None:
        versions = [t._version for t in self._tracked]
        if versions != self._versions:
            self.store.check_weights(self.unet, stamp(self._tensors))
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
            out = self.store.run(key, fn, inputs, self._session)
        return out if return_cache else out[0]


def graphed_eps_model(unet, store: GraphStore | None = None) -> GraphedEps:
    """``unet``'s evals captured and replayed through ``store`` (the
    process's ``STORE`` when None): a drop-in for the U-Net in the sampling
    loops, DeepCache's calls included.  Checks ``unet``'s tensors against
    its captures first (the module docstring)."""
    return GraphedEps(unet, STORE if store is None else store)


def eps_model_for(unet, device, graphs: bool = True):
    """The model a sampling call hands its loop: ``graphed_eps_model(unet)``
    where ``graphs`` and ``graphs_apply(device)``, else ``unet`` itself."""
    if graphs and graphs_apply(device):
        return graphed_eps_model(unet)
    return unet

