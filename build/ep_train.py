"""Only the expert-parallel training phases of `chip_smoke.py`, with what
they stand beside: `device`, `build`, `train-params`, `train-step`, then
`ep-train` and `ep-train-grads` (with K5's receive-buffer cases). Needs
one CUDA card; each phase prints its JSON line as in the whole script,
and a failed check raises. Run from the root of the checkout:

    python3 build/ep_train.py
"""
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402

cs.phase_device()
cs.phase_build()
cfg = cs.get_config(cs.ARCH)
params, opt_state, opt = cs.phase_train_params(cfg)
state, batch, *_ = cs.phase_train_step(cfg, params, opt_state, opt)
del params, opt_state, state, _
gc.collect()
torch.cuda.empty_cache()
calls5 = cs.phase_ep_train(cfg, batch)
gc.collect()
torch.cuda.empty_cache()
cs.phase_ep_train_grads(calls5)
print("ep-train phases passed")
