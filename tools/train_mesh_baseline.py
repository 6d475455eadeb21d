"""Whether a bf16 step on a mesh learns as a one-device step does.

Run from the repository root on a machine with a CUDA card::

    PYTHONPATH=src python tools/train_mesh_baseline.py

It trains xLSTM-350M at full width and depth (bf16, 8 x 256 tokens from
the ``TokenPipeline``) through ``train()`` five times: on one device and on
a (2, 2) mesh of gloo ranks sharing the card, each at lr 3e-2 (the
``train xlstm-350m`` phase's) and at lr 0 (the params stay where they
start: each step's loss is the starting params' loss on that step's
batch), and once more on the mesh with ``chip_smoke.py``'s checkpoint at
step 2 and failure at step 3.  A step's loss minus its lr-0 loss is what
the updates so far did to it; a mesh run that did not learn would keep
its lr-0 losses.  It prints one JSON line a run (losses and grad norms by
step).
"""

import contextlib
import json
import sys
import tempfile

from repro_torch.launch.train import TrainConfig, train


def run(tag, **kw):
    cfg = dict(arch="xlstm-350m", steps=5, batch=8, seq_len=256,
               save_every=100, log_every=100, device="cuda")
    cfg.update(kw)
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(sys.stderr):
        out = train(TrainConfig(ckpt_dir=d, **cfg))
    print(tag, json.dumps({"loss_steps": out["loss_steps"],
                           "losses": out["losses"],
                           "grad_norms": out["grad_norms"]}), flush=True)


if __name__ == "__main__":
    run("one lr0", lr=0.0)
    run("one lr3e-2", lr=3e-2)
    run("mesh lr3e-2", lr=3e-2, mesh_shape=(2, 2))
    run("mesh lr3e-2 restart", lr=3e-2, mesh_shape=(2, 2), steps=4,
        save_every=2, fail_at=(3,))
    run("mesh lr0", lr=0.0, mesh_shape=(2, 2), steps=4)
