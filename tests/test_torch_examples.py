"""The port's examples run on the CPU, each in its own subprocess.

``examples/torch_*.py`` run at a reduced size with ``--device cpu``: the
cartpole swing-up at horizon 30 (a horizon that solves from the cold
start) with 4 starts, 6 closed-loop quadrotor steps, the joint-θ example
as written (float64, tol 1e-10), and the sharded robust-tree example under
``torchrun`` with 2 gloo ranks.  Each must exit 0, which holds it to its
own assertions, and must import no ``jax`` module: ``PYTHONPROFILEIMPORTTIME``
makes every Python process (torchrun's ranks too) list each module it
imports on stderr.  The four start together and run side by side.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

RUNS = {
    "cartpole": ["torch_cartpole_swingup.py", "--device", "cpu",
                 "--horizon", "30", "--batch", "4"],
    "quadrotor": ["torch_quadrotor_mpc.py", "--device", "cpu",
                  "--steps", "6"],
    "joint_theta": ["torch_joint_theta_estimation.py", "--device", "cpu"],
    "robust_sharded": ["torch_robust_mpc_sharded.py", "--device", "cpu"],
}
# what each prints when its run is whole
EXPECT = {
    "cartpole": r"(?s)nominal start: status=0 .*\nbatch of 4: solved",
    "quadrotor": r"6 warm-started re-solves: all solved",
    "joint_theta": r"shared theta\* = .* \(bit-identical on every "
                   r"scenario: True\)",
    "robust_sharded": r"ranks: 2 \(cpu\), scenarios: 8 .*\nsolved 8/8",
}
JAX_IMPORT = re.compile(r"^import time:.*\|\s+jax(\.\S+)?\s*$", re.M)


def _command(name):
    script, *args = RUNS[name]
    path = os.path.join(EXAMPLES, script)
    if name == "robust_sharded":
        torchrun = shutil.which("torchrun") or "torchrun"
        return [torchrun, "--standalone", "--nproc-per-node", "2", path,
                *args]
    return [sys.executable, path, *args]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(exit code, stdout, stderr) of each run.  The output goes to files:
    the import logs overflow a pipe that nobody reads while the test
    waits for another run."""
    logs = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1", OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", PYTHONWARNINGS="ignore")
    procs = {}
    try:
        for name in RUNS:
            with open(logs / f"{name}.out", "w") as out, \
                    open(logs / f"{name}.err", "w") as err:
                procs[name] = subprocess.Popen(_command(name), stdout=out,
                                               stderr=err, env=env, cwd=REPO)
        codes = {name: proc.wait(timeout=150)
                 for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return {name: (codes[name], (logs / f"{name}.out").read_text(),
                   (logs / f"{name}.err").read_text()) for name in RUNS}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu_without_jax(runs, name):
    code, stdout, stderr = runs[name]
    errors = "\n".join(line for line in stderr.splitlines()
                       if not line.startswith("import time:"))
    assert code == 0, (stdout, errors[-4000:])
    assert re.search(EXPECT[name], stdout), stdout
    # the import log is there, and names no jax module
    assert "import time:" in stderr
    assert not JAX_IMPORT.search(stderr), JAX_IMPORT.search(stderr).group(0)
