"""Run the REFERENCE package's own pytest suite against dsptoolbox_jax.

The strongest drop-in-compatibility proof available: every test file under
/root/reference/tests does ``import dsptoolbox as dsp``; this runner aliases
``dsptoolbox`` to ``dsptoolbox_jax`` (in float64 mode, so strict
``assert_array_equal`` round-trips hold) and executes the reference suite
unmodified, in place, out of the read-only reference tree.

Usage:
    python tools/run_reference_tests.py [extra pytest args...]

Notes
-----
- float64 + x64 jax on CPU: the reference's tests assert exact float64
  round-trips of ``time_data`` (e.g. tests/test_standard.py:29), which a
  float32 device container cannot satisfy. This mode exists for oracle
  work (`dsptoolbox_jax._config.set_default_float`).
- CWD must be the repo root: one reference test writes tests/f.pkl relative
  to CWD (`/root/reference/tests/test_standard.py:326-329`).
- No files are written under /root/reference (cacheprovider disabled,
  basetemp redirected).
"""

import os
import sys

os.environ.setdefault("MPLBACKEND", "Agg")
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

# soundfile/sounddevice stand-ins (the environment has neither library);
# identical to the ones the main suite installs.
from conftest import _install_audio_stubs  # noqa: E402

_install_audio_stubs()

import dsptoolbox_jax  # noqa: E402
from dsptoolbox_jax._config import set_default_float  # noqa: E402

set_default_float("float64")

# The alias: reference tests import `dsptoolbox` — serve ours instead.
sys.modules["dsptoolbox"] = dsptoolbox_jax


# Submodule imports (`from dsptoolbox.classes.lattice_ladder_filter import
# ...`, reference tests/test_filterbanks.py:338) bypass the sys.modules
# alias and would re-execute our packages under the aliased name (circular
# import). A meta-path finder maps every `dsptoolbox.*` module to the
# already-imported `dsptoolbox_jax.*` equivalent instead.
import importlib  # noqa: E402
import importlib.abc  # noqa: E402
from importlib.machinery import ModuleSpec  # noqa: E402


class _AliasLoader(importlib.abc.Loader):
    def create_module(self, spec):
        real_name = "dsptoolbox_jax" + spec.name[len("dsptoolbox"):]
        return importlib.import_module(real_name)

    def exec_module(self, module):
        pass


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "dsptoolbox" or name.startswith("dsptoolbox."):
            return ModuleSpec(name, _AliasLoader())
        return None


sys.meta_path.insert(0, _AliasFinder())

import pytest  # noqa: E402

if __name__ == "__main__":
    os.chdir(REPO)
    extra = sys.argv[1:]
    # an explicit test path in the extra args replaces the whole-suite
    # default (file-by-file runs isolate slow files / crashes)
    has_path = any(a.startswith("/root/reference/tests") for a in extra)
    args = ([] if has_path else ["/root/reference/tests"]) + [
        "-q",
        "-p",
        "no:cacheprovider",
        "--basetemp",
        "/tmp/ref_suite_tmp",
        "--continue-on-collection-errors",
    ] + extra
    raise SystemExit(pytest.main(args))
