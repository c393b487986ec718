"""The data-plane rules (DML209, DML214).

Counterpart of ``dmlcloud_tpu/lint/rules_data.py``. Packing (``DataPipeline.pack``/``pack_stream``, ``pack_sequences``,
``native.pack.pack_flat``) puts SEVERAL documents into one row; the row is
only equivalent to training the documents separately when BOTH consumers
honor the segment ids: the model call (attention must not cross a segment
boundary, positions must restart per segment) and the loss (a position
whose target lies in another segment — or in padding — must not
contribute). Dropping ``segment_ids`` at either point is silent
cross-document attention leakage: the loss stays finite, the curves look
plausible, and the model is learning to predict across randomly packed
document boundaries — the worst failure mode of packing, invisible until
evaluation.

DML209 fires in any scope that provably BUILDS a packed pipeline (flow-
aware: ``.pack(...)``/``.pack_stream(...)`` receivers are chased through
assignment and import aliases to a ``DataPipeline``; the free functions
``pack_sequences``/``pack_sequences_fast``/``pack_flat`` are unambiguous)
when that same scope:

- calls ``lm_loss``/``chunked_lm_loss`` without ``segment_ids`` (third
  positional for ``lm_loss``, keyword otherwise), or
- dispatches a model on packed tokens without a ``segment_ids`` keyword:
  a module call (``model(...)``, ``state.model(...)``, ``self.model(...)``,
  ``model.forward(...)`` — ``DecoderLM.forward`` takes ``segment_ids``) or
  the reference's ``.apply``/``apply_fn`` call, whose arguments subscript
  ``...["tokens"]``.

The scope is the enclosing top-level class (pipeline built in
``pre_stage``, loss computed in ``step`` — same stage class, one packing
decision) or top-level function, else the module's own statements; an
unpacked module's ``lm_loss(logits, tokens)`` never matches. Passing
``segment_ids=None`` explicitly is clean — the plumbing exists, the value
is a runtime decision (examples/train_lm.py's ``--pack`` flag).
"""

from __future__ import annotations

import ast

from . import dataflow
from .engine import Finding, ModuleCtx, rule, walk_fn

__all__ = ["check_packed_segment_ids", "check_blocking_data_io"]

#: unambiguous packed-pipeline builders (free-function / terminal-attr form)
_PACKER_NAMES = frozenset({"pack_stream", "pack_sequences", "pack_sequences_fast", "pack_flat"})

#: loss entry points that accept the packed contract
_LOSS_NAMES = frozenset({"lm_loss", "chunked_lm_loss"})

#: model dispatch spellings: the module call (``model(...)``,
#: ``state.model(...)``, ``model.forward(...)``) and the reference's flax
#: ``model.apply`` / TrainState ``apply_fn``
_APPLY_NAMES = frozenset({"apply", "apply_fn", "model", "forward"})


def _f(ctx: ModuleCtx, node: ast.AST, message: str, context: str = "") -> Finding:
    return Finding("DML209", ctx.path, node.lineno, node.col_offset, message, context)


def _terminal_name(ctx: ModuleCtx, func: ast.AST) -> str:
    resolved = ctx.resolve(func) or ""
    last = resolved.split(".")[-1] if resolved else ""
    if not last and isinstance(func, ast.Attribute):
        last = func.attr
    if not last and isinstance(func, ast.Name):
        last = func.id
    return last


def _is_pipelineish(ctx: ModuleCtx, node: ast.AST, scopes, depth: int = 8) -> bool:
    """Whether an expression provably denotes a DataPipeline (the receiver
    of a ``.pack(...)`` call): the ``DataPipeline`` name itself, a
    combinator chain rooted at one, or a binding that resolves to either —
    so ``struct.pack(...)`` and other unrelated ``.pack`` receivers stay
    silent."""
    if depth <= 0 or node is None:
        return False
    if isinstance(node, ast.Call):
        return _is_pipelineish(ctx, node.func, scopes, depth - 1)
    if isinstance(node, ast.Attribute):
        resolved = ctx.resolve(node) or ""
        if "DataPipeline" in resolved.split("."):
            return True
        return _is_pipelineish(ctx, node.value, scopes, depth - 1)
    if isinstance(node, ast.Name):
        if "DataPipeline" in ctx.aliases.get(node.id, node.id).split("."):
            return True
        bound = dataflow.resolve_expr(node, scopes)
        if bound is not None and bound is not node:
            return _is_pipelineish(ctx, bound, scopes, depth - 1)
    return False


def _packs(ctx: ModuleCtx, call: ast.Call) -> bool:
    last = _terminal_name(ctx, call.func)
    if last in _PACKER_NAMES:
        return True
    if last == "pack" and isinstance(call.func, ast.Attribute):
        return _is_pipelineish(ctx, call.func.value, ctx.scopes_at(call))
    return False


def _has_segment_ids(call: ast.Call) -> bool:
    return any(kw.arg == "segment_ids" for kw in call.keywords)


def _subscripts_tokens(call: ast.Call) -> bool:
    """Any argument reading a ``...["tokens"]`` leaf — the packed batch's
    token buffer by contract (pack emits ``{"tokens", "segment_ids"}``)."""
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Subscript):
                sl = sub.slice
                if isinstance(sl, ast.Constant) and sl.value == "tokens":
                    return True
    return False


def _scope_nodes(tree: ast.Module):
    """Top-level scopes: each top-level class (all its methods — the stage
    idiom splits build and step across methods), each top-level function,
    and the module's remaining statements as one scope."""
    rest: list[ast.stmt] = []
    for stmt in tree.body:
        if isinstance(stmt, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt, [stmt]
        else:
            rest.append(stmt)
    if rest:
        yield tree, rest


@rule("DML209", "packed pipeline drops segment_ids at the model call or loss")
def check_packed_segment_ids(ctx: ModuleCtx):
    for scope, stmts in _scope_nodes(ctx.tree):
        calls = [
            n for stmt in stmts for n in ast.walk(stmt) if isinstance(n, ast.Call)
        ]
        pack_call = next((c for c in calls if _packs(ctx, c)), None)
        if pack_call is None:
            continue
        scope_name = getattr(scope, "name", "")
        for call in calls:
            last = _terminal_name(ctx, call.func)
            if last in _LOSS_NAMES:
                positional_segs = last == "lm_loss" and len(call.args) >= 3
                if _has_segment_ids(call) or positional_segs:
                    continue
                yield _f(
                    ctx, call,
                    f"{last}(...) without segment_ids in a scope that packs its "
                    f"data (line {pack_call.lineno}): every cross-document and "
                    "padding target silently contributes to the loss — pass the "
                    "packed rows' segment_ids through to the loss",
                    scope_name,
                )
            elif last in _APPLY_NAMES and _subscripts_tokens(call) and not _has_segment_ids(call):
                yield _f(
                    ctx, call,
                    f"model {last}(...) consumes packed tokens without "
                    f"segment_ids (scope packs at line {pack_call.lineno}): "
                    "attention crosses document boundaries and positions do not "
                    "restart per segment — pass segment_ids so the packed row "
                    "computes exactly what the unpacked documents would",
                    scope_name,
                )


# ------------------------------------------------------------------- DML214

#: module.attr loaders that read + deserialize a file in one blocking call
_BLOCKING_LOADERS = frozenset({
    "numpy.load",
    "numpy.loadtxt",
    "numpy.genfromtxt",
    "numpy.fromfile",
    "json.load",
    "pickle.load",
    "torch.load",
})


@rule("DML214", "blocking file I/O inside step/epoch code")
def check_blocking_data_io(ctx: ModuleCtx):
    """File reads on the training thread (``open().read()``, ``np.load``,
    ``json.load``, ``pickle.load``) stall the dispatch queue for the full
    disk round trip — per step, that is the difference between a compute-
    bound run and a disk-bound one, and the telemetry ledger books it as
    unexplained step time rather than ``data_wait``. The disk-native data
    plane exists so this never happens on the hot path: build the corpus
    offline (scripts/torch_build_corpus.py), read it through the mmap'd
    ``ShardReader`` (data/store.py — page faults land on the
    ``dml-shard-reader`` thread), or, for genuinely unavoidable reads,
    account them under ``StallTimer.measure()`` so the ledger sees them."""
    for fn in ctx.step_fns + ctx.epoch_fns:
        for node, in_measure in walk_fn(fn.node):
            if in_measure or not isinstance(node, ast.Call):
                continue
            resolved = ctx.resolve(node.func) or ""
            if isinstance(node.func, ast.Name) and resolved == "open":
                yield Finding(
                    "DML214", ctx.path, node.lineno, node.col_offset,
                    f"open() inside {fn.kind} code blocks training on disk "
                    "I/O; read through the mmap'd shard store "
                    "(data/store.py ShardReader) or account the read under "
                    "StallTimer.measure()",
                    fn.qualname,
                )
            elif resolved in _BLOCKING_LOADERS:
                yield Finding(
                    "DML214", ctx.path, node.lineno, node.col_offset,
                    f"{resolved}(...) inside {fn.kind} code reads and "
                    "deserializes a file on the training thread; stage data "
                    "through the disk-native shard format "
                    "(scripts/torch_build_corpus.py + ShardReader) or account it "
                    "under StallTimer.measure()",
                    fn.qualname,
                )
