"""static.nn: data-dependent control flow that stays inside a captured
program.

Port of ``paddle_tpu/static/nn.py``: ``cond`` (:160), ``while_loop``
(:191), ``case`` (:250) and ``switch_case`` (:285), over ``torch.cond``
and ``torch._higher_order_ops.while_loop`` where the JAX package uses
``lax.cond`` / ``lax.switch`` / ``lax.while_loop``. The modes:

* eager: the predicate or index is read and the taken branch runs (the
  loop runs as a Python loop), so gradients flow through the taken
  branch as through any other eager code;
* under ``jit.to_static`` (``torch.compiler.is_compiling()``): each call
  is one higher-order node of the one captured graph, with no graph
  break: ``cond`` one ``cond``, ``case`` and ``switch_case`` one
  ``cond`` whose false branch holds the next test, ``while_loop`` one
  ``while_loop``. ``cond``, ``case`` and ``switch_case`` differentiate
  through the taken branch there too;
* ``while_loop`` with a loop variable that needs a gradient raises, as
  the JAX function does: a dynamic trip count has no bounded adjoint.

Branch callables take no arguments (the reference's convention), so the
tensors they use are free variables. The JAX package lifts them into
operands by walking the closures (``_captured_tensors``); dynamo lifts a
traced function's free variables itself, so nothing here walks them.
A branch's outputs are copied inside the captured branch (a higher-order
op refuses an output that aliases an input or another output); eager
branches return their values as they are.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _traced() -> bool:
    return torch.compiler.is_compiling()


def _pred(p) -> torch.Tensor:
    """A predicate as the 0-d bool tensor ``torch.cond`` takes."""
    if not isinstance(p, torch.Tensor):
        return torch.tensor(bool(p))
    if p.dtype != torch.bool:
        p = p.to(torch.bool)
    return p.reshape(())


def _fresh(fn: Callable) -> Callable:
    """``fn`` as a captured branch: each tensor it returns a copy."""
    def branch(*args):
        return pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            fn(*args))
    return branch


# ---------------------------------------------------------------------------
# cond
# ---------------------------------------------------------------------------

def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """Run ``true_fn()`` or ``false_fn()`` by the runtime value of
    ``pred`` (reference control_flow.py:1509). Both branches return the
    same structure of tensors; gradients flow through the taken branch
    to any tensors the branches use."""
    if isinstance(pred, (bool, int)):
        fn = true_fn if pred else false_fn
        return fn() if fn is not None else None
    if true_fn is None and false_fn is None:
        return None
    if true_fn is None or false_fn is None:
        raise ValueError(
            "cond needs both true_fn and false_fn (the reference requires "
            "matching outputs; one-armed cond has no output structure)")
    if _traced():
        return torch.cond(_pred(pred), _fresh(true_fn), _fresh(false_fn))
    return true_fn() if bool(_pred(pred)) else false_fn()


# ---------------------------------------------------------------------------
# while_loop
# ---------------------------------------------------------------------------

def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Repeat ``body`` while ``cond`` holds (reference control_flow.py:682).
    ``cond``/``body`` take the loop vars positionally; ``body`` returns
    the same arity. Returns the final loop vars as a list. Reverse-mode
    gradients are not defined (a dynamic trip count has no bounded
    adjoint program): a loop var that needs one raises, with the
    alternatives."""
    if not callable(cond) or not callable(body):
        raise TypeError("cond and body in while_loop must be callable")
    if not isinstance(loop_vars, (list, tuple)) or len(loop_vars) == 0:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in loop_vars):
        raise ValueError(
            "while_loop is not differentiable: its trip count is dynamic, "
            "so reverse mode would need unbounded activation storage. "
            "Detach the inputs, wrap the call in torch.no_grad(), or "
            "restructure as a bounded loop (a Python range under "
            "jit.to_static) to differentiate")

    def step(*vs):
        out = body(*vs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)

    if _traced():
        from torch._higher_order_ops.while_loop import while_loop as loop
        return list(loop(lambda *vs: _pred(cond(*vs)), _fresh(step),
                         tuple(loop_vars)))
    vs = tuple(loop_vars)
    while bool(_pred(cond(*vs))):
        vs = step(*vs)
    return list(vs)


# ---------------------------------------------------------------------------
# case / switch_case
# ---------------------------------------------------------------------------

def _first_true(tests, fns, default):
    """The branch of the first true test, else ``default``: eager, the
    tests read in order; captured, one ``cond`` per test, each next one
    inside the false branch of the one before."""
    if not _traced():
        for test, fn in zip(tests, fns):
            if bool(_pred(test())):
                return fn()
        return default()

    def chain(i):
        if i == len(fns):
            return _fresh(default)
        return lambda: torch.cond(_pred(tests[i]()), _fresh(fns[i]),
                                  chain(i + 1))

    return chain(0)()


def case(pred_fn_pairs, default=None, name=None):
    """First pair whose pred is true wins; else ``default`` (reference
    control_flow.py:961; the last fn doubles as the default)."""
    if not isinstance(pred_fn_pairs, (list, tuple)) or not pred_fn_pairs:
        raise TypeError("pred_fn_pairs must be a non-empty list/tuple")
    preds, fns = [], []
    for pair in pred_fn_pairs:
        if not isinstance(pair, (list, tuple)) or len(pair) != 2:
            raise TypeError(f"each pred_fn_pair must be (pred, fn): {pair!r}")
        p, f = pair
        if not callable(f):
            raise TypeError("fn in pred_fn_pairs must be callable")
        preds.append(p)
        fns.append(f)
    if default is None:
        default = fns[-1]
    return _first_true([lambda p=p: p for p in preds], fns, default)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Select a branch by integer index (reference control_flow.py:1084).
    ``branch_fns``: a list of callables (indices 0..n-1), a dict, or a
    list of (index, callable) pairs; an index with no branch takes
    ``default`` (the highest index's branch when None)."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif isinstance(branch_fns, (list, tuple)) and branch_fns and \
            callable(branch_fns[0]):
        pairs = list(enumerate(branch_fns))
    else:
        pairs = sorted((int(i), f) for i, f in branch_fns)
    keys = [i for i, _ in pairs]
    if len(set(keys)) != len(keys):
        raise ValueError(f"duplicate branch indices: {keys}")
    fns = [f for _, f in pairs]
    for f in fns:
        if not callable(f):
            raise TypeError("branch_fns entries must be callable")
    if default is None:
        default = fns[-1]
    bi = branch_index
    if isinstance(bi, torch.Tensor):
        bi = bi.reshape(())
    return _first_true([lambda k=k: bi == k for k in keys], fns, default)
