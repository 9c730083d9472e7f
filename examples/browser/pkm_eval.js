/* Browser/JS `.pkm` host: a NON-Python host executing pharmsol-tpu artifacts.
 *
 * The reference proves its portable tier in a browser (browser-compile-bridge/
 * README.md:1-18 exposes the DSL compiler to browsers; tests/browser-e2e/
 * run.mjs executes the WASM bundle in a page). This rebuild's portable
 * artifact is plain JSON (`.pkm`, dsl/runtime.py save_artifact), and this
 * file is the browser analogue of the reference's JS loader
 * (src/dsl/wasm_compile.rs:30-43 bundle = bytes + metadata + JS loader):
 * it parses the artifact and evaluates the statement IR with nothing but
 * ECMAScript — no wasm, no server.
 *
 * Evaluation contract: dsl/pure.py is the reference implementation; this is
 * a line-for-line port (same RK4 step-count rule, same exact closed-form
 * segment propagation via a scaling-and-squaring affine matrix exponential,
 * same Euler-Maruyama cloud for SDE artifacts). The C++ host
 * (native/src/pkm_host.cpp) is the third implementation of the same
 * contract; tests/test_pkm_host.py pins C++ vs pure vs jitted, and
 * examples/browser/index.html pins THIS host against jitted-engine
 * expectations baked by make_demo.py.
 */
"use strict";

const INTRINSICS = {
  abs: Math.abs, min: Math.min, max: Math.max,
  floor: Math.floor, ceil: Math.ceil,
  exp: Math.exp, ln: Math.log, log: Math.log,
  log10: Math.log10, log2: Math.log2,
  pow: Math.pow, round: Math.round,
  sin: Math.sin, cos: Math.cos, tan: Math.tan, sqrt: Math.sqrt,
};

const BINOPS = {
  "+": (a, b) => a + b,
  "-": (a, b) => a - b,
  "*": (a, b) => a * b,
  "/": (a, b) => a / b,
  "^": (a, b) => Math.pow(a, b),
  "==": (a, b) => a === b,
  "!=": (a, b) => a !== b,
  "<": (a, b) => a < b,
  "<=": (a, b) => a <= b,
  ">": (a, b) => a > b,
  ">=": (a, b) => a >= b,
  "&&": (a, b) => Boolean(a) && Boolean(b),
  "||": (a, b) => Boolean(a) || Boolean(b),
};

/* Expressions arrive as the raw `.pkm` JSON arrays (dsl/ast.py Expr.to_json):
 * ["number", v] | ["bool", v] | ["name", n] | [kind, name, [args...]]. */
function evalExpr(expr, env) {
  const kind = expr[0];
  if (kind === "number") return expr[1];
  if (kind === "bool") return Boolean(expr[1]);
  if (kind === "name") {
    const v = env.get(expr[1]);
    if (v === undefined) throw new Error(`unbound name \`${expr[1]}\` at runtime`);
    return v;
  }
  const name = expr[1];
  const args = expr[2];
  if (kind === "unary") {
    const v = evalExpr(args[0], env);
    if (name === "-") return -v;
    if (name === "+") return v;
    return !Boolean(v);
  }
  if (kind === "binary") {
    return BINOPS[name](evalExpr(args[0], env), evalExpr(args[1], env));
  }
  if (kind === "call") {
    const fn = INTRINSICS[name];
    if (!fn) throw new Error(`unknown function \`${name}\` at runtime`);
    return fn(...args.map((a) => evalExpr(a, env)));
  }
  if (kind === "index") {
    const base = args[0];
    const i = Math.trunc(evalExpr(args[1], env));
    const v = env.get(`${base[1]}[${i}]`);
    if (v === undefined) throw new Error(`unbound slot \`${base[1]}[${i}]\``);
    return v;
  }
  throw new Error(`unsupported expression \`${kind}\``);
}

/* Statements arrive as the raw `.pkm` JSON objects (dsl/ast.py Stmt.to_json). */
function evalStmts(stmts, env) {
  for (const s of stmts) {
    if (s.kind === "assign" || s.kind === "let") {
      if (s.kind === "assign" && s.target_kind === "call") {
        for (const a of s.target_args) {
          env.set(`${s.target}:${a}`, evalExpr(s.value, env));
        }
      } else if (s.kind === "assign" && s.target_kind === "index") {
        const i = Math.trunc(evalExpr(s.index, env));
        env.set(`${s.target}:${s.index_base}[${i}]`, evalExpr(s.value, env));
      } else {
        env.set(s.target, evalExpr(s.value, env));
      }
    } else if (s.kind === "if") {
      evalStmts(evalExpr(s.condition, env) ? s.then : s.else, env);
    } else if (s.kind === "for") {
      const lo = Math.trunc(evalExpr(s.start, env));
      const hi = Math.trunc(evalExpr(s.end, env));
      for (let i = lo; i < hi; i++) {
        env.set(s.binding, i);
        evalStmts(s.body, env);
      }
      env.delete(s.binding);
    }
  }
  return env;
}

/* Carry/linear interpolation over (time, value) knots (data/covariate.py). */
class PkmCovariate {
  constructor(knots, fixed = false) {
    this.knots = knots.map(([t, v]) => [Number(t), Number(v)])
      .sort((a, b) => a[0] - b[0]);
    this.fixed = Boolean(fixed);
  }
  at(t) {
    const ks = this.knots;
    if (!ks.length) return 0.0;
    if (t <= ks[0][0]) return ks[0][1];
    for (let i = 0; i + 1 < ks.length; i++) {
      const [t0, v0] = ks[i];
      const [t1, v1] = ks[i + 1];
      if (t0 <= t && t < t1) {
        if (this.fixed || t1 === t0) return v0;
        return v0 + ((v1 - v0) * (t - t0)) / (t1 - t0);
      }
    }
    return ks[ks.length - 1][1];
  }
}

/* Closed-form kernel compartment matrices in micro-constant form
 * (engine/analytical.py conventions; same table as dsl/pure.py). Each
 * entry: [remap(kp) -> micro kp, build(kp) -> [A rows, central index]]. */
const A_1 = (kp) => [[[-kp[0]]], 0];
const A_1_ORAL = (kp) => [[[-kp[0], 0], [kp[0], -kp[1]]], 1];
const A_2 = (kp) => {
  const [ke, kcp, kpc] = kp;
  return [[[-(ke + kcp), kpc], [kcp, -kpc]], 0];
};
const A_2_ORAL = (kp) => {
  const [ke, ka, kcp, kpc] = kp;
  return [[[-ka, 0, 0], [ka, -(ke + kcp), kpc], [0, kcp, -kpc]], 1];
};
const A_3 = (kp) => {
  const [k10, k12, k13, k21, k31] = kp;
  return [[[-(k10 + k12 + k13), k21, k31], [k12, -k21, 0], [k13, 0, -k31]], 0];
};
const A_3_ORAL = (kp) => {
  const [ka, k10, k12, k13, k21, k31] = kp;
  return [[
    [-ka, 0, 0, 0],
    [ka, -(k10 + k12 + k13), k21, k31],
    [0, k12, -k21, 0],
    [0, k13, 0, -k31],
  ], 1];
};

const PKM_KERNELS = {
  one_compartment: [(kp) => kp, A_1],
  one_compartment_with_absorption: [(kp) => kp, A_1_ORAL],
  one_compartment_cl: [(kp) => [kp[0] / kp[1]], A_1],
  one_compartment_cl_with_absorption: [(kp) => [kp[0], kp[1] / kp[2]], A_1_ORAL],
  two_compartments: [(kp) => kp, A_2],
  two_compartments_with_absorption: [(kp) => kp, A_2_ORAL],
  two_compartments_cl: [
    (kp) => [kp[0] / kp[2], kp[1] / kp[2], kp[1] / kp[3]], A_2],
  two_compartments_cl_with_absorption: [
    (kp) => [kp[1] / kp[3], kp[0], kp[2] / kp[3], kp[2] / kp[4]], A_2_ORAL],
  three_compartments: [(kp) => kp, A_3],
  three_compartments_cl: [
    (kp) => [kp[0] / kp[3], kp[1] / kp[3], kp[2] / kp[3],
             kp[1] / kp[4], kp[2] / kp[5]], A_3],
  three_compartments_with_absorption: [(kp) => kp, A_3_ORAL],
  three_compartments_cl_with_absorption: [
    (kp) => [kp[0], kp[1] / kp[4], kp[2] / kp[4], kp[3] / kp[4],
             kp[2] / kp[5], kp[3] / kp[6]], A_3_ORAL],
};

/* (P, q) with exp([[A*dt, u*dt], [0, 0]]) = [[P, q], [0, 1]]; scaling-and-
 * squaring Taylor-13 Horner on the affine block (pure.py _expm_affine_py). */
function expmAffine(A, u, dt) {
  const n = A.length;
  const Adt = A.map((row) => row.map((x) => x * dt));
  const udt = u.map((x) => x * dt);
  let norm = 0.0;
  for (let i = 0; i < n; i++) {
    let r = Math.abs(udt[i]);
    for (let j = 0; j < n; j++) r += Math.abs(Adt[i][j]);
    norm = Math.max(norm, r);
  }
  const s = norm > 1.0 ? Math.max(0, Math.ceil(Math.log2(norm))) : 0;
  const scale = Math.pow(0.5, s);
  const As = Adt.map((row) => row.map((x) => x * scale));
  const us = udt.map((x) => x * scale);
  const mm = (X, Y) => X.map((row, i) =>
    row.map((_, j) => {
      let acc = 0.0;
      for (let l = 0; l < n; l++) acc += X[i][l] * Y[l][j];
      return acc;
    }));
  const mv = (X, y) => X.map((row) => {
    let acc = 0.0;
    for (let l = 0; l < n; l++) acc += row[l] * y[l];
    return acc;
  });
  const eye = (i, j) => (i === j ? 1.0 : 0.0);
  let P = As.map((row, i) => row.map((x, j) => eye(i, j) + x / 13.0));
  let q = us.map((x) => x / 13.0);
  for (let d = 12; d > 0; d--) {
    const AP = mm(As, P);
    P = AP.map((row, i) => row.map((x, j) => eye(i, j) + x / d));
    const Aq = mv(As, q);
    q = Aq.map((x, i) => (x + us[i]) / d);
  }
  for (let k = 0; k < s; k++) {
    const Pq = mv(P, q);
    q = Pq.map((x, i) => x + q[i]);
    P = mm(P, P);
  }
  return [P, q];
}

/* Deterministic standard-normal stream: xorshift128+ bits through a
 * Box-Muller pair. SDE clouds only need a reproducible-per-seed stream —
 * cross-host draw-for-draw parity with Python's Mersenne gauss is NOT part
 * of the contract (pure.py: mean predictions; zero-diffusion artifacts
 * reproduce the deterministic tiers exactly). */
class GaussStream {
  constructor(seed) {
    this.s0 = BigInt(seed >>> 0) * 2685821657736338717n + 1442695040888963407n;
    this.s1 = (this.s0 ^ 0x9e3779b97f4a7c15n) * 0xbf58476d1ce4e5b9n;
    this.s0 &= 0xffffffffffffffffn;
    this.s1 &= 0xffffffffffffffffn;
    this.spare = null;
    for (let i = 0; i < 8; i++) this.u01();
  }
  u01() {
    let x = this.s0;
    const y = this.s1;
    this.s0 = y;
    x = (x ^ (x << 23n)) & 0xffffffffffffffffn;
    x ^= x >> 17n;
    x ^= y ^ (y >> 26n);
    this.s1 = x & 0xffffffffffffffffn;
    const out = (this.s0 + this.s1) & 0xffffffffffffffffn;
    return Number(out >> 11n) / 9007199254740992.0; // 53-bit mantissa
  }
  gauss() {
    if (this.spare !== null) {
      const v = this.spare;
      this.spare = null;
      return v;
    }
    let u = 0.0;
    while (u <= 1e-300) u = this.u01();
    const r = Math.sqrt(-2.0 * Math.log(u));
    const th = 2.0 * Math.PI * this.u01();
    this.spare = r * Math.sin(th);
    return r * Math.cos(th);
  }
}

class PkmModel {
  constructor(payload) {
    if (payload.format !== "pharmsol-tpu-pkm") {
      throw new Error("not a pharmsol-tpu artifact");
    }
    const m = payload.model;
    this.name = m.name;
    this.kind = m.kind;
    this.parameters = m.parameters.slice();
    this.covariates = m.covariates.map((c) => c[0]);
    this.states = m.states.slice();
    this.stateArrays = m.state_arrays || {};
    this.outputs = m.outputs.slice();
    this.constants = m.constants;
    this.derived = (m.derived || []).slice();
    this.analyticalKernel = m.analytical || null;
    this.kernelPlan = m.kernel_plan || null;
    this.particles = m.particles || null;
    this.deriveStmts = m.derive;
    this.dynamicsStmts = m.dynamics;
    this.outputStmts = m.outputs_stmts;
    this.initStmts = m.init;
    this.diffusionStmts = m.diffusion || [];
    this.stateSlots = [];
    for (const s of this.states) {
      if (s in this.stateArrays) {
        for (let i = 0; i < this.stateArrays[s]; i++) this.stateSlots.push(`${s}[${i}]`);
      } else {
        this.stateSlots.push(s);
      }
    }
  }

  env(params, t, cov) {
    const env = new Map([["t", Number(t)]]);
    this.parameters.forEach((name, i) => env.set(name, Number(params[i])));
    for (const name of this.covariates) {
      env.set(name, cov && cov[name] ? cov[name].at(t) : 0.0);
    }
    for (const [k, v] of Object.entries(this.constants)) env.set(k, v);
    return evalStmts(this.deriveStmts, env);
  }

  init(params, cov) {
    const env = this.env(params, 0.0, cov);
    evalStmts(this.initStmts, env);
    return this.stateSlots.map((s) => env.get(`init:${s}`) ?? 0.0);
  }

  dynamics(x, params, t, cov) {
    const env = this.env(params, t, cov);
    this.stateSlots.forEach((slot, i) => env.set(slot, x[i]));
    evalStmts(this.dynamicsStmts, env);
    return this.stateSlots.map((s) => env.get(`dx:${s}`) ?? 0.0);
  }

  out(x, params, t, cov) {
    const env = this.env(params, t, cov);
    this.stateSlots.forEach((slot, i) => env.set(slot, x[i]));
    evalStmts(this.outputStmts, env);
    return this.outputs.map((o) => env.get(`out:${o}`) ?? 0.0);
  }

  diffusion(params, t, cov) {
    const env = this.env(params, t, cov);
    evalStmts(this.diffusionStmts, env);
    return this.states.map((s) => env.get(`noise:${s}`) ?? 0.0);
  }

  kernelInputs(params, t, cov) {
    if (!this.kernelPlan) throw new Error("artifact has no analytical kernel plan");
    const env = this.env(params, t, cov);
    return this.kernelPlan.bindings.map(([source, index]) => {
      if (source === "primary") return Number(params[index]);
      if (source === "covariate") {
        const name = this.covariates[index];
        return cov && cov[name] ? cov[name].at(t) : 0.0;
      }
      return env.get(this.derived[index]);
    });
  }

  /* Event-timeline simulation for every artifact kind (pure.py simulate):
   * boluses = [[time, amount, stateIndex], ...]; returns one output row per
   * observation time. */
  simulate(params, boluses, obsTimes, opts = {}) {
    const cov = opts.cov || null;
    const dt = opts.dt ?? 0.01;
    if (this.kind === "analytical") {
      return this.simulateAnalytical(params, boluses, obsTimes, cov);
    }
    if (this.kind === "sde") {
      return this.simulateSde(params, boluses, obsTimes, cov, dt,
                              opts.nparticles, opts.seed ?? 0);
    }
    if (this.kind !== "ode") {
      throw new Error(`pkm host supports ode/analytical/sde, not ${this.kind}`);
    }
    let x = this.init(params, cov);
    let t = 0.0;
    const events = this.timeline(boluses, obsTimes);
    const results = [];
    const rk4To = (t0, t1, x0) => {
      const n = Math.max(1, Math.ceil((t1 - t0) / dt));
      const h = (t1 - t0) / n;
      let xc = x0;
      for (let i = 0; i < n; i++) {
        const ti = t0 + i * h;
        const k1 = this.dynamics(xc, params, ti, cov);
        const k2 = this.dynamics(xc.map((a, s) => a + 0.5 * h * k1[s]), params, ti + 0.5 * h, cov);
        const k3 = this.dynamics(xc.map((a, s) => a + 0.5 * h * k2[s]), params, ti + 0.5 * h, cov);
        const k4 = this.dynamics(xc.map((a, s) => a + h * k3[s]), params, ti + h, cov);
        xc = xc.map((a, s) => a + (h / 6.0) * (k1[s] + 2 * k2[s] + 2 * k3[s] + k4[s]));
      }
      return xc;
    };
    for (const [et, kind, amount, idx] of events) {
      if (et > t) {
        x = rk4To(t, et, x);
        t = et;
      }
      if (kind === "obs") results.push(this.out(x, params, t, cov));
      else x[idx] += amount;
    }
    return results;
  }

  timeline(boluses, obsTimes) {
    const events = boluses.map(([bt, amt, idx]) => [bt, "bolus", amt, idx])
      .concat(obsTimes.map((ot) => [ot, "obs", 0.0, 0]));
    // contract parity (pure.py sorted() on (time, kind, amount, idx) tuples,
    // native/src/pkm_host.cpp Event::operator<): at equal times
    // "bolus" < "obs" lexicographically, then amount, then index.
    events.sort((a, b) => (a[0] - b[0])
      || ((a[1] === "bolus" ? 0 : 1) - (b[1] === "bolus" ? 0 : 1))
      || (a[2] - b[2]) || (a[3] - b[3]));
    return events;
  }

  simulateAnalytical(params, boluses, obsTimes, cov) {
    const entry = PKM_KERNELS[this.analyticalKernel];
    if (!entry) throw new Error(`unknown analytical kernel \`${this.analyticalKernel}\``);
    const [remap, buildA] = entry;
    let x = this.init(params, cov);
    const n = x.length;
    let t = 0.0;
    const results = [];
    for (const [et, kind, amount, idx] of this.timeline(boluses, obsTimes)) {
      if (et > t) {
        // kernel inputs at the segment END (engine parity: dsl/runtime
        // make_analytical_propagate derives at t0+dt)
        const kp = remap(this.kernelInputs(params, et, cov));
        const [A] = buildA(kp);
        const [P, q] = expmAffine(A, new Array(n).fill(0.0), et - t);
        x = P.map((row, i) => row.reduce((acc, p, j) => acc + p * x[j], q[i]));
        t = et;
      }
      if (kind === "obs") results.push(this.out(x, params, t, cov));
      else x[idx] += amount;
    }
    return results;
  }

  simulateSde(params, boluses, obsTimes, cov, dt, nparticles, seed) {
    const Pn = Math.trunc(nparticles || this.particles || 100);
    const rng = new GaussStream(seed);
    const x0 = this.init(params, cov);
    const n = x0.length;
    const cloud = Array.from({ length: Pn }, () => x0.slice());
    let t = 0.0;
    const results = [];
    const emTo = (t0, t1) => {
      const steps = Math.max(1, Math.ceil((t1 - t0) / dt));
      const h = (t1 - t0) / steps;
      const sq = Math.sqrt(h);
      for (let i = 0; i < steps; i++) {
        const ti = t0 + i * h;
        const g = this.diffusion(params, ti, cov);
        for (const part of cloud) {
          const d = this.dynamics(part, params, ti, cov);
          for (let s = 0; s < n; s++) part[s] += d[s] * h + g[s] * rng.gauss() * sq;
        }
      }
    };
    for (const [et, kind, amount, idx] of this.timeline(boluses, obsTimes)) {
      if (et > t) {
        emTo(t, et);
        t = et;
      }
      if (kind === "obs") {
        const acc = new Array(this.outputs.length).fill(0.0);
        for (const part of cloud) {
          const o = this.out(part, params, t, cov);
          for (let k = 0; k < acc.length; k++) acc[k] += o[k];
        }
        results.push(acc.map((v) => v / Pn));
      } else {
        for (const part of cloud) part[idx] += amount;
      }
    }
    return results;
  }
}

// Usable both from a plain <script> tag and from module hosts.
if (typeof window !== "undefined") {
  window.PharmsolPkm = { PkmModel, PkmCovariate, evalExpr, evalStmts, expmAffine };
}
if (typeof module !== "undefined" && module.exports) {
  module.exports = { PkmModel, PkmCovariate, evalExpr, evalStmts, expmAffine };
}
