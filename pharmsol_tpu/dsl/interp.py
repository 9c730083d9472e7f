"""Trace-time interpreter: DSL statements -> traced JAX values.

This is the jit-traced replacement for the reference's Cranelift JIT
(src/dsl/jit.rs): instead of lowering the ExecutionModel IR to machine code,
the IR is walked once inside ``jax.jit`` tracing, producing a jaxpr. After
tracing there is zero interpretation overhead — XLA compiles the same fused
program a hand-written closure would produce.

Semantics:

- call-target assignments (``dx(s) = ...``, ``out(o) = ...``) write keyed
  env slots (``dx:s``) so they participate in if-branch merging;
- ``if`` evaluates both branches and merges every modified slot with
  ``jnp.where`` (compiler-friendly select, no data-dependent control flow);
- ``for`` requires constant bounds and unrolls at trace time;
- intrinsics map to jnp equivalents; ``^`` is power; ``&&``/``||`` are
  logical; comparisons produce booleans usable in ``if`` conditions.
"""

from __future__ import annotations

from typing import Dict, List

import jax.numpy as jnp

from .ast import Expr, Stmt
from .diagnostic import Diagnostic, DslError

_INTRINSICS = {
    "abs": jnp.abs,
    "min": jnp.minimum,
    "max": jnp.maximum,
    "floor": jnp.floor,
    "ceil": jnp.ceil,
    "exp": jnp.exp,
    "ln": jnp.log,
    "log": jnp.log,
    "log10": jnp.log10,
    "log2": jnp.log2,
    "pow": jnp.power,
    "round": jnp.round,
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tan": jnp.tan,
    "sqrt": jnp.sqrt,
}

_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "^": jnp.power,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&&": jnp.logical_and,
    "||": jnp.logical_or,
}


def eval_expr(expr: Expr, env: Dict[str, object]):
    if expr.kind == "number":
        return expr.value
    if expr.kind == "bool":
        return bool(expr.value)
    if expr.kind == "name":
        try:
            return env[expr.name]
        except KeyError:
            raise DslError(
                Diagnostic.error("DSL3001", f"unbound name `{expr.name}` at runtime", expr.span)
            )
    if expr.kind == "unary":
        v = eval_expr(expr.args[0], env)
        if expr.name == "-":
            return -v
        if expr.name == "+":
            return v
        return jnp.logical_not(v)
    if expr.kind == "binary":
        a = eval_expr(expr.args[0], env)
        b = eval_expr(expr.args[1], env)
        return _BINOPS[expr.name](a, b)
    if expr.kind == "call":
        fn = _INTRINSICS.get(expr.name)
        if fn is None:
            raise DslError(
                Diagnostic.error("DSL3002", f"unknown function `{expr.name}`", expr.span)
            )
        return fn(*(eval_expr(a, env) for a in expr.args))
    if expr.kind == "index":
        base, idx_expr = expr.args
        idx = eval_expr(idx_expr, env)
        if hasattr(idx, "aval"):  # traced value — indices must resolve at trace time
            raise DslError(
                Diagnostic.error(
                    "DSL3006",
                    "state index must be a constant (loop variables and literals "
                    "are allowed; runtime values are not)",
                    idx_expr.span,
                )
            )
        i = int(idx)
        if base.kind == "name":
            # array-state element: env binds expanded names like `x[0]`
            key = f"{base.name}[{i}]"
            if key in env:
                return env[key]
            if base.name not in env:
                raise DslError(
                    Diagnostic.error(
                        "DSL3007",
                        f"index {i} out of range for array state `{base.name}`",
                        expr.span,
                    )
                )
        return eval_expr(base, env)[i]
    raise DslError(Diagnostic.error("DSL3003", f"bad expression kind `{expr.kind}`", expr.span))


def _const_int(expr: Expr, env: Dict[str, object], what: str) -> int:
    v = eval_expr(expr, env)
    if hasattr(v, "aval"):  # traced value — not allowed as a loop bound
        raise DslError(
            Diagnostic.error(
                "DSL3004",
                f"{what} must be a constant (got a runtime value)",
                expr.span,
            )
        )
    return int(v)


def eval_stmts(stmts: List[Stmt], env: Dict[str, object]) -> Dict[str, object]:
    """Execute statements, mutating a copy of env; returns the final env."""
    env = dict(env)
    for s in stmts:
        if s.kind == "let":
            env[s.target] = eval_expr(s.value, env)
        elif s.kind == "assign":
            value = eval_expr(s.value, env)
            if s.target_kind == "call":
                for arg in s.target_args:
                    env[f"{s.target}:{arg}"] = value
            elif s.target_kind == "index":
                # dx(x[i]) / dx[i]: keyed slot on the expanded element name so
                # it participates in if-branch merging like scalar dx targets
                i = _const_int(s.index_expr, env, "state index")
                env[f"{s.target}:{s.index_base}[{i}]"] = value
            else:
                env[s.target] = value
        elif s.kind == "if":
            cond = eval_expr(s.condition, env)
            then_env = eval_stmts(s.then_branch, env)
            else_env = eval_stmts(s.else_branch, env)
            keys = set(then_env) | set(else_env)
            for k in keys:
                tv = then_env.get(k, env.get(k))
                ev = else_env.get(k, env.get(k))
                if tv is None or ev is None:
                    # assigned in only one branch with no prior value:
                    # visible only when that branch wins; keep branch value,
                    # fall back to 0.0 on the other side (reference IR zeroes
                    # uninitialized buffer slots)
                    tv = 0.0 if tv is None else tv
                    ev = 0.0 if ev is None else ev
                if tv is ev:
                    env[k] = tv
                else:
                    env[k] = jnp.where(cond, tv, ev)
        elif s.kind == "for":
            start = _const_int(s.range_start, env, "for-range start")
            end = _const_int(s.range_end, env, "for-range end")
            for i in range(start, end):
                env[s.binding] = float(i)
                env = eval_stmts(s.body, env)
            env.pop(s.binding, None)
        else:
            raise DslError(Diagnostic.error("DSL3005", f"bad statement kind `{s.kind}`", s.span))
    return env
