"""examples/quickstart_torch.py runs on the CPU (``--device cpu``, the
plain path) in a process where jax and the JAX package cannot be
imported, and recovers what it injected: the clean, one-DLA and two-DLA
spectra each pick their model, the MAP absorbers within 0.01 in z."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_quickstart_runs_on_the_cpu_without_jax():
    code = (
        "import json, runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gp_dla_detection_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "sys.argv = ['quickstart_torch.py', '--device', 'cpu', '--num-samples', '1000']\n"
        "ns = runpy.run_path('examples/quickstart_torch.py')\n"
        "out = ns['main'](sys.argv[1:])\n"
        "print(json.dumps({'picks': out['model_posteriors'].argmax(axis=1).tolist(),\n"
        "                  'z_single': out['z_single'], 'z_pair': out['z_pair']}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["picks"] == [0, 1, 2]
    assert abs(out["z_single"] - 2.62) < 0.01
    assert abs(out["z_pair"][0] - 2.45) < 0.01 and abs(out["z_pair"][1] - 2.85) < 0.01
