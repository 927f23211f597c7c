"""``python -m minsdtf_tpu_torch.parallel.dryrun --n 4 --device cpu``: the port's
counterpart of ``__graft_entry__.py`` ``dryrun_multichip`` on four ``gloo`` CPU
ranks (mesh (2, 2)) exits 0 and prints the JAX script's lines, and the count of
each kind of collective of its spatial sequence-parallel run."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_on_four_cpu_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "minsdtf_tpu_torch.parallel.dryrun", "--n", "4", "--device",
         "cpu", "--timeout", "240"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "dryrun_multichip: mesh data=2 model=2"
    assert lines[1].startswith("dryrun_multichip train step OK: loss=")
    assert lines[2] == ("dryrun_multichip serving (sampler.generate, DP x TP) OK: "
                        "image (2, 64, 64, 3)")
    assert lines[3] == ("dryrun_multichip sequence-parallel (spatial, ring attention) OK: "
                        "image (1, 128, 128, 3)")
    counts = dict(part.rsplit(" ", 1) for part in
                  lines[4].removeprefix("dryrun_multichip sequence-parallel collectives: ")
                  .split(", "))
    assert set(counts) == {"all_reduce", "all_gather", "ring_shift", "halo"}, lines[4]
    assert all(int(counts[kind]) > 0 for kind in counts), lines[4]
    assert lines[5:] == ["dryrun_multichip OK"]
