"""The port's lint rules: GL001-GL007, the JAX package's guarantee
lessons with the reference's logic (`repro.analysis.rules`) and torch
hints, and PT001-PT003, three lessons the port paid for itself
(`src/repro_torch/DESIGN.md`, "The guarantee linter").

Rules are heuristic by design: they match the shape of a bug class, and
a per-file `# repro: noqa <id> -- reason` takes a sound exception.  Pure
stdlib `ast`.
"""
from __future__ import annotations

import ast
import re

from .walker import Finding, register_rule

_FLOAT_DTYPES = {"float16", "float32", "float64", "bfloat16"}


# ------------------------------------------------------- ast utilities ---

def _funcs(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _dotted(node) -> str:
    """The dotted name of a Name/Attribute chain ('torch.argsort'); '' for
    anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _idents(node):
    """Every Name id and Attribute attr in a subtree."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _has_float_dtype(node) -> bool:
    """Does this subtree name a floating dtype (torch.float32, .to(f32),
    dtype='float32')?"""
    for n in ast.walk(node):
        if isinstance(n, (ast.Name, ast.Attribute)):
            if (n.id if isinstance(n, ast.Name) else n.attr) in _FLOAT_DTYPES:
                return True
        elif isinstance(n, ast.Constant) and n.value in _FLOAT_DTYPES:
            return True
    return False


def _calls(node, names: set):
    """Call nodes in a subtree whose callee's last segment is in `names`."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d and d.split(".")[-1] in names:
                yield n


def _name_segments(name: str) -> set:
    return set(name.lower().split("_")) - {""}


def _method(call: ast.Call) -> str:
    """The attribute a call invokes (`x.to(...)` -> 'to'), '' otherwise."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else ""


# ------------------------------------------------------------ GL rules ---

class GL001:
    """Float-typed accumulation in wire/bit accounting (the JAX package's
    PR 5 drift class): a float32 sum over word or bit counts rounds past
    2^24, and the reported wire size drifts from the shipped one.
    Accumulate exact int words, convert to float once at the end."""
    id = "GL001"
    title = "float-typed accumulation in wire/bit accounting"
    hint = ("accumulate word counts as int32/int64 and convert once "
            "(codec.transmitted_bits)")
    _SCOPE = re.compile(r"wire_bits|wire_bytes|transmitted|bytes_moved"
                        r"|account")

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            if not self._SCOPE.search(fn.name):
                continue
            for call in _calls(fn, {"sum", "cumsum"}):
                if any(_has_float_dtype(a) for a in call.args) or \
                        any(_has_float_dtype(k.value) for k in call.keywords):
                    yield Finding(
                        self.id, path, call.lineno,
                        f"`{fn.name}` accumulates in floating point "
                        f"inside accounting (f32 sums drift past 2^24 "
                        f"words)", self.hint)


class GL002:
    """Reconstruction acceptance without the overflow guard (the JAX
    package's PR 1 ABS bug): `|x - bin*eb2| <= eb` passes with a finite x
    when bin*eb2 overflows to inf, and the decoder ships inf."""
    id = "GL002"
    title = "reconstruction check missing the overflow guard"
    hint = ("guard the reconstruction with torch.isfinite(recon) before "
            "accepting |x - recon| <= eb")

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            if "isfinite" in set(_idents(fn)):
                continue
            assigned = {}
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                        isinstance(n.targets[0], ast.Name):
                    assigned[n.targets[0].id] = n.value

            def has_product(node) -> bool:
                for s in ast.walk(node):
                    if isinstance(s, ast.BinOp) and isinstance(s.op, ast.Mult):
                        return True
                    if isinstance(s, ast.Name) and s.id in assigned:
                        for t in ast.walk(assigned[s.id]):
                            if isinstance(t, ast.BinOp) and \
                                    isinstance(t.op, ast.Mult):
                                return True
                return False

            for cmp in ast.walk(fn):
                if not (isinstance(cmp, ast.Compare)
                        and all(isinstance(op, (ast.LtE, ast.Lt))
                                for op in cmp.ops)):
                    continue
                for call in _calls(cmp.left, {"abs", "absolute"}):
                    sub = next((s for a in call.args for s in ast.walk(a)
                                if isinstance(s, ast.BinOp)
                                and isinstance(s.op, ast.Sub)), None)
                    if sub is not None and has_product(sub):
                        yield Finding(
                            self.id, path, cmp.lineno,
                            f"`{fn.name}` accepts |x - recon| against a "
                            f"bound with no isfinite guard on the "
                            f"product reconstruction", self.hint)
                        break


class GL003:
    """TIGHTEN in an audit/violation predicate: encoders accept only
    `diff <= eb*TIGHTEN`, but auditors test the plain bound; a tightened
    audit flags clean encodes at the margin."""
    id = "GL003"
    title = "TIGHTEN used in an audit/violation predicate"
    hint = ("audit against the plain requested bound; only encoders "
            "tighten (core.audit.audit_report)")
    _SCOPE = re.compile(r"audit|verify|violat|detect")

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            if not self._SCOPE.search(fn.name):
                continue
            for n in ast.walk(fn):
                ident = (n.id if isinstance(n, ast.Name)
                         else n.attr if isinstance(n, ast.Attribute) else "")
                if "tighten" in ident.lower():
                    yield Finding(
                        self.id, path, n.lineno,
                        f"`{fn.name}` references `{ident}` — auditors "
                        f"must use the plain bound, not the encoder's "
                        f"tightened one", self.hint)


class GL004:
    """Open-loop prediction: a predictor that reads the original values
    instead of the bin plane diverges from the decoder, and the bound is
    lost.  `encode_bins`/`decode_bins` touch only the bins they get."""
    id = "GL004"
    title = "open-loop prediction (reads the original plane)"
    hint = ("predict from the bin/reconstructed plane only (core.predict's "
            "closed loop)")
    _PLANE_NAMES = {"x", "values", "orig", "original", "raw", "x_orig"}

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            if fn.name not in ("encode_bins", "decode_bins"):
                continue
            args = {a.arg for a in fn.args.args} | \
                {a.arg for a in fn.args.kwonlyargs}
            leaked = args & self._PLANE_NAMES
            used = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            hit = sorted(leaked | (used & self._PLANE_NAMES))
            if hit:
                yield Finding(
                    self.id, path, fn.lineno,
                    f"`{fn.name}` touches the original value plane "
                    f"({', '.join(hit)}) — predictors must be closed-"
                    f"loop on the bin plane", self.hint)


class GL005:
    """Transmitted length used without validation: slicing a payload by a
    wire-carried `payload_len` without `check_payload_len` or a clamp
    lets a corrupt length index garbage."""
    id = "GL005"
    title = "transmitted length used without validation"
    hint = ("call audit.check_payload_len (host) or clamp with "
            "torch.clamp/torch.minimum before consuming payload_len")
    _VALIDATORS = {"check_payload_len", "clip", "minimum", "clamp",
                   "gather_chunks", "decode_words", "decode_word_stages"}

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            called = {_dotted(c.func).split(".")[-1]
                      for c in ast.walk(fn) if isinstance(c, ast.Call)}
            if called & self._VALIDATORS:
                continue
            len_names = {"payload_len"}
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                        isinstance(n.targets[0], ast.Name) and \
                        any(i == "payload_len" for i in _idents(n.value)):
                    len_names.add(n.targets[0].id)
            for n in ast.walk(fn):
                if isinstance(n, ast.Subscript) and \
                        set(_idents(n.slice)) & len_names:
                    yield Finding(
                        self.id, path, n.lineno,
                        f"`{fn.name}` indexes by a transmitted "
                        f"payload_len with no length validation in "
                        f"scope", self.hint)


class GL006:
    """Non-deterministic seeding of numpy generators: data and fault plans
    must reproduce across processes, so an np generator is seeded by
    `zlib.crc32` of its suite's name; a bare `default_rng()` is
    time-seeded, a literal int forks the convention, `hash()` varies per
    process."""
    id = "GL006"
    title = "numpy seeding off the crc32 convention"
    hint = ("seed as np.random.default_rng(zlib.crc32(name.encode())); a "
            "torch stream as torch.Generator().manual_seed(seed)")

    def check(self, tree, text, path):
        for call in _calls(tree, {"default_rng", "seed"}):
            d = _dotted(call.func)
            if d.split(".")[-1] == "seed" and "random" not in d:
                continue                       # some other .seed() method
            if not call.args and not call.keywords:
                yield Finding(
                    self.id, path, call.lineno,
                    "unseeded RNG construction (time-seeded, "
                    "irreproducible)", self.hint)
                continue
            ok = any("crc32" in _idents(a) for a in call.args)
            hashed = any(isinstance(c, ast.Call)
                         and _dotted(c.func) == "hash"
                         for a in call.args for c in ast.walk(a))
            if hashed:
                yield Finding(
                    self.id, path, call.lineno,
                    "RNG seeded via hash() (varies per process under "
                    "PYTHONHASHSEED)", self.hint)
            elif not ok:
                yield Finding(
                    self.id, path, call.lineno,
                    "RNG seeded off the crc32 convention "
                    "(irreproducible-by-name)", self.hint)


class GL007:
    """Host output inside a codec path: `print`/`breakpoint`/host
    callbacks inside encode/decode/quantize functions force host syncs
    and belong in callers."""
    id = "GL007"
    title = "host callback inside an encode/decode path"
    hint = ("move the print/debug call to the caller, or use the "
            "verify=/AuditReport plumbing")
    _SEGMENTS = {"encode", "decode", "pack", "unpack", "quantize",
                 "dequantize"}
    _BANNED = {"print", "breakpoint", "io_callback", "pure_callback"}

    def check(self, tree, text, path):
        if "benchmarks" in path:
            return                 # benches print by design (host-side)
        for fn in _funcs(tree):
            if not (_name_segments(fn.name) & self._SEGMENTS):
                continue
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                d = _dotted(call.func)
                if d.startswith("jax.debug") or \
                        (d and d.split(".")[-1] in self._BANNED):
                    yield Finding(
                        self.id, path, call.lineno,
                        f"`{fn.name}` calls `{d}` inside a codec path",
                        self.hint)


# ------------------------------------------------------------ PT rules ---

_INT_DTYPES = {"int8", "int16", "int32", "int64", "long", "int", "short",
               "uint8"}
_INT_METHODS = {"int", "long", "short"}
_NAN_MAPS = {"isnan", "nan_to_num", "isfinite"}
# names of integer planes by the port's convention: a cast of one widens
# or narrows ints, and no NaN can reach it
_INT_PLANES = {"bins", "words", "idx", "codes", "pos", "count", "lengths"}


class PT001:
    """A float-to-int cast with no NaN mapping before it, in a quantize or
    bins function (ROADMAP C-port-4): torch on the CPU casts NaN to
    INT32_MIN where XLA and CUDA give 0, so a plain-torch twin of a
    kernel diverges on NaN unless it maps NaN to 0 first.  A cast of a
    value named as an integer plane (`bins`, `words`, `idx`, ...) is an
    int-to-int cast and passes."""
    id = "PT001"
    title = "float-to-int cast with no NaN mapping (C-port-4)"
    hint = ("map NaN to 0 first (torch.where(torch.isnan(v), 0, v) or "
            "torch.nan_to_num) before .to(torch.int32)/.int()/.long()")
    _SCOPE = {"quantize", "bins", "bin"}

    @staticmethod
    def _is_int_cast(call: ast.Call) -> bool:
        m = _method(call)
        if m and set(_idents(call.func.value)) & _INT_PLANES:
            return False
        if m in _INT_METHODS and not call.args:
            return True
        if m != "to":
            return False
        dts = list(call.args) + [k.value for k in call.keywords
                                 if k.arg == "dtype"]
        return any(isinstance(a, ast.Attribute) and a.attr in _INT_DTYPES
                   and _dotted(a).startswith("torch.") for a in dts)

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            if not (_name_segments(fn.name) & self._SCOPE):
                continue
            maps = [n.lineno for n in ast.walk(fn)
                    if isinstance(n, (ast.Name, ast.Attribute))
                    and (n.id if isinstance(n, ast.Name) else n.attr)
                    in _NAN_MAPS]
            for call in ast.walk(fn):
                if isinstance(call, ast.Call) and self._is_int_cast(call) \
                        and not any(ln <= call.lineno for ln in maps):
                    yield Finding(
                        self.id, path, call.lineno,
                        f"`{fn.name}` casts to an int dtype with no NaN "
                        f"mapping before it (torch's CPU gives INT32_MIN, "
                        f"XLA and CUDA 0)", self.hint)


_OTHER_ARRAYS = {"jnp", "np", "numpy", "jax", "lax"}


class PT002:
    """A sort without `stable=True` (PR 16's ent codebook, PR 19's MoE
    routing): `jnp.argsort` and `lax.top_k` are stable, `torch.argsort`
    and `torch.sort` are not by default, so ties come out in another
    order than the reference's."""
    id = "PT002"
    title = "torch sort without stable=True"
    hint = "pass stable=True to torch.argsort / torch.sort / Tensor.sort"

    @staticmethod
    def _is_torch_sort(call: ast.Call) -> bool:
        d = _dotted(call.func)
        if d in ("torch.argsort", "torch.sort"):
            return True
        if d.split(".")[0] in _OTHER_ARRAYS:
            return False               # jnp.argsort, np.sort: stable or
        m = _method(call)              # not torch's to fix
        if m == "argsort":
            return True
        # Tensor.sort(dim, ...); a list's .sort() takes no positional args
        return m == "sort" and not d.startswith("torch.") and (
            bool(call.args) or any(k.arg in ("dim", "descending", "stable")
                                   for k in call.keywords))

    def check(self, tree, text, path):
        for call in ast.walk(tree):
            if not (isinstance(call, ast.Call) and self._is_torch_sort(call)):
                continue
            stable = any(k.arg == "stable" and isinstance(k.value,
                                                          ast.Constant)
                         and k.value.value is True for k in call.keywords)
            if not stable:
                yield Finding(
                    self.id, path, call.lineno,
                    f"`{_dotted(call.func) or 'sort'}` without stable=True "
                    f"(ties leave in another order than the reference's)",
                    self.hint)


class PT003:
    """Arithmetic on a torch.uint32 tensor ("Word planes are int32"): on
    the CPU, torch has no +, >>, <<, max for uint32, so word planes stay
    int32 and uint32 is only a view taken to compare."""
    id = "PT003"
    title = "arithmetic on a torch.uint32 tensor"
    hint = ("keep the plane int32 (a logical shift is >> then a mask); "
            "take .view(torch.uint32) only to compare")
    _OPS = (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv, ast.Mod, ast.LShift,
            ast.RShift, ast.BitOr, ast.BitAnd, ast.BitXor, ast.Pow)
    _REDUCE = {"max", "maximum", "min", "minimum", "sum", "cumsum"}

    @staticmethod
    def _is_u32(node) -> bool:
        return (isinstance(node, ast.Call)
                and _method(node) in ("view", "to", "type")
                and any(_dotted(a) == "torch.uint32" for a in node.args))

    def check(self, tree, text, path):
        for fn in _funcs(tree):
            u32 = set()
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                        isinstance(n.targets[0], ast.Name) and \
                        self._is_u32(n.value):
                    u32.add(n.targets[0].id)

            def is_u32(node) -> bool:
                return self._is_u32(node) or (isinstance(node, ast.Name)
                                              and node.id in u32)

            for n in ast.walk(fn):
                hit = None
                if isinstance(n, ast.BinOp) and isinstance(n.op, self._OPS) \
                        and (is_u32(n.left) or is_u32(n.right)):
                    hit = type(n.op).__name__
                elif isinstance(n, ast.AugAssign) and \
                        isinstance(n.op, self._OPS) and \
                        (is_u32(n.target) or is_u32(n.value)):
                    hit = type(n.op).__name__
                elif isinstance(n, ast.Call) and \
                        _dotted(n.func).split(".")[-1] in self._REDUCE and \
                        any(is_u32(a) for a in n.args):
                    hit = _dotted(n.func)
                if hit:
                    yield Finding(
                        self.id, path, n.lineno,
                        f"`{fn.name}` applies {hit} to a torch.uint32 "
                        f"tensor (torch's CPU has no uint32 arithmetic)",
                        self.hint)


for _rule in (GL001, GL002, GL003, GL004, GL005, GL006, GL007,
              PT001, PT002, PT003):
    register_rule(_rule())
