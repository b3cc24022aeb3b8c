"""tools.mxlint over the port, ``mxnet_tpu_torch/``.

The suite is the JAX package's static analysis (lock discipline,
signal safety, atomic writes, the env-knob catalogue, stale knobs and
suppressions, thread lifecycle, telemetry naming, trace propagation,
retrace hazards), run without editing ``tools/``. Three project facts
are pointed at the port for the run:

- the env-knob catalogue is read from ``mxnet_tpu_torch/env.py``
  (``ProjectContext`` reads ``mxnet_tpu/env.py``);
- the stale-knob scan also reads ``mxnet_tpu_torch/`` and
  ``chip_smoke.py``;
- the port's own atomic-write seams, ``base.py::atomic_write`` and
  ``checkpoint/manager.py::_open_for_write``, join a copy of
  ``WriteChecker``'s ``SANCTIONED`` seams.

Each check is one case: the port must have no finding of it.
"""
import os
import shutil

import pytest

from tools.mxlint import CHECKS, core, render_text, run_suite
from tools.mxlint.checkers import staleknobs, writes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mxnet_tpu_torch")


@pytest.fixture(scope="module")
def port_result(tmp_path_factory):
    """One run of the whole suite over the port."""
    shadow = tmp_path_factory.mktemp("lint_root")
    os.makedirs(shadow / "mxnet_tpu")
    shutil.copy(os.path.join(PORT, "env.py"), shadow / "mxnet_tpu" / "env.py")
    shutil.copy(os.path.join(ROOT, "README.md"), shadow / "README.md")

    class PortContext(core.ProjectContext):
        """The repo's context with the port's knob catalogue: parsed from
        a copy laid out where ProjectContext looks, then re-anchored."""

        def __init__(self, root):
            super().__init__(str(shadow))
            self.root = os.path.abspath(root)
            self.env_py = os.path.normpath(os.path.join(PORT, "env.py"))

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(core, "ProjectContext", PortContext)
        mp.setattr(writes, "SANCTIONED", set(writes.SANCTIONED) | {
            ("mxnet_tpu_torch/base.py", "atomic_write"),
            ("mxnet_tpu_torch/checkpoint/manager.py", "_open_for_write")})
        mp.setattr(staleknobs, "SCAN_ROOTS", staleknobs.SCAN_ROOTS + (
            "mxnet_tpu_torch", "chip_smoke.py"))
        yield run_suite([PORT], root=ROOT)
    finally:
        mp.undo()


def test_suite_reads_the_port(port_result):
    assert not port_result.errors, port_result.errors
    assert port_result.files >= 100


@pytest.mark.parametrize("check", sorted(set(CHECKS) | {"bad-suppression"}))
def test_port_is_clean(port_result, check):
    found = [f for f in port_result.findings if f.check == check]
    result = core.RunResult(findings=found)
    assert not found, render_text(result)
