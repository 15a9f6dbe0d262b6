"""The launch seam of ``_build``: the one tensor check every kernel wrapper
runs before it passes pointers, and the one launch counter. The kernels
themselves run on the card only (``test_torch_cuda_kernels.py``); here the
wrappers are read as source: every launch goes through ``_build.launch``
under a name of the module's ``KERNELS``, and nothing else counts."""
import ast
import importlib
import inspect
import re

import pytest
import torch

from mav_detection_tpu_torch import _build

WRAPPERS = ("mav_detection_tpu_torch.ops.flow.farneback_iter",
            "mav_detection_tpu_torch.ops.flow.farneback_expand",
            "mav_detection_tpu_torch.ops.image.detect_rates",
            "mav_detection_tpu_torch.models.raft_lookup",
            "mav_detection_tpu_torch.ops.flow.shift_probes")


class _CudaLike:
    """What ``check_tensor`` reads of a tensor, on a CUDA device (this
    machine has no card to make a real one on)."""

    def __init__(self, dtype=torch.float32, shape=(2, 3), contiguous=True):
        self.is_cuda, self.device = True, torch.device("cuda", 0)
        self.dtype, self.shape, self._contiguous = dtype, torch.Size(shape), contiguous

    def is_contiguous(self) -> bool:
        return self._contiguous


@pytest.mark.parametrize("fault,tensor,match,layout_fault", [
    ("cpu", torch.zeros(2, 3), r"x must be a contiguous torch.float32 CUDA tensor, "
                               r"got torch.float32 on cpu", False),
    ("dtype", _CudaLike(dtype=torch.float64), r"got torch.float64 on cuda:0", False),
    ("contiguity", _CudaLike(contiguous=False), r"\(contiguous=False\)", True),
    ("shape", _CudaLike(shape=(3, 2)), r"x: shape \(3, 2\) != \(2, 3\)", True),
])
def test_check_tensor_refuses(fault, tensor, match, layout_fault):
    """Each refusal of the wrappers' one tensor check, a ValueError naming
    the input. Without ``shape`` (the rates kernel, which takes any layout)
    only the device and the dtype are checked."""
    _build.check_tensor("x", _CudaLike(), (2, 3))
    with pytest.raises(ValueError, match=match):
        _build.check_tensor("x", tensor, (2, 3))
    if layout_fault:
        _build.check_tensor("x", tensor)
    else:
        with pytest.raises(ValueError, match="x must be a torch.float"):
            _build.check_tensor("x", tensor)


def _innermost_function(tree: ast.AST, node: ast.AST):
    found = None
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and any(n is node for n in ast.walk(fn)):
            found = fn       # ast.walk visits outer functions first
    return found


def _kernel_names(expr: ast.AST, tree: ast.AST, kernels) -> set:
    """The names a launch's kernel argument can take: a literal, an item of
    ``KERNELS``, an f-string (the kernels it can spell), or a local name
    followed to its assignment or, for a parameter, to the module's calls."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.Subscript) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "KERNELS" and isinstance(expr.slice, ast.Constant):
        return {kernels[expr.slice.value]}
    if isinstance(expr, ast.JoinedStr):
        pattern = "".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                          for v in expr.values)
        spelt = {k for k in kernels if re.fullmatch(pattern, k)}
        assert spelt, f"f-string {ast.unparse(expr)} spells no kernel of {kernels}"
        return spelt
    if isinstance(expr, ast.Name):
        fn = _innermost_function(tree, expr)
        assigned = [a.value for a in ast.walk(fn) if isinstance(a, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == expr.id for t in a.targets)]
        if assigned:
            return set().union(*(_kernel_names(v, tree, kernels) for v in assigned))
        params = [a.arg for a in fn.args.args]
        assert expr.id in params, f"{expr.id} in {fn.name}: neither assigned nor a parameter"
        pos = params.index(expr.id)
        calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
                 and isinstance(c.func, ast.Name) and c.func.id == fn.name]
        assert calls, f"{fn.name} is never called in its module"
        return set().union(*(_kernel_names(c.args[pos], tree, kernels) for c in calls))
    raise AssertionError(f"cannot tell which kernel {ast.unparse(expr)} names")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_launch_and_count_their_kernels_only(name):
    """Every launch of the module goes through ``_build.launch`` (a
    library ``_build`` builds, a kernel name of the module's ``KERNELS``,
    which the counter holds), and the module touches no counter itself."""
    mod = importlib.import_module(name)
    tree = ast.parse(inspect.getsource(mod))
    assert set(mod.KERNELS) <= set(_build.LAUNCHES)
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.Name) and n.id == "LAUNCHES"
                or isinstance(n, ast.Attribute) and n.attr == "LAUNCHES"]
    launches = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute) and c.func.attr == "launch"]
    assert launches
    for call in launches:
        assert ast.unparse(call.func) == "_build.launch"
        assert call.args[0].value in _build.SOURCES
        names = _kernel_names(call.args[1], tree, mod.KERNELS)
        assert names <= set(mod.KERNELS), (ast.unparse(call), names)


def test_reset_launches_zeroes_every_kernel():
    kernels = {k for name in WRAPPERS for k in importlib.import_module(name).KERNELS}
    saved = dict(_build.LAUNCHES)
    assert kernels <= set(saved)
    try:
        for i, k in enumerate(_build.LAUNCHES):
            _build.LAUNCHES[k] = i + 1
        _build.reset_launches()
        assert _build.LAUNCHES == dict.fromkeys(saved, 0)
    finally:
        _build.LAUNCHES.update(saved)
