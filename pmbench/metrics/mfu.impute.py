"""Model FLOPs of an imputation request (``work/pm_vqvae.py``) times the window's
requests a second, over the float32 peak."""
from pmbench.readers import mfu_pct
from pmbench.work import peaks
from pmbench.work.pm_vqvae import request_flops


def read(cell, outcome):
    if not outcome.facts.get("window_s"):
        return None
    per_s = outcome.facts["requests"] / outcome.facts["window_s"]
    return mfu_pct(request_flops(cell.config, cell.traffic), per_s, peaks.FLOAT32_FLOPS)
