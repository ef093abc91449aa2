"""What the PM-VQVAE drivers share: the reference's shapes and weights, the
program's model built from the same weights, the seeded splits."""
from __future__ import annotations

import numpy as np
import torch

from pmbench import weights
from pmbench.harness import sub_seed
from pmbench.reference import pm_vqvae as ref

U8_SCALE = np.float32(1.0 / 255.0)


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """The run's weights on ``device``, keyed as both models' state dicts."""
    meta = ref.build(cfg, "meta")
    rules = ref.init_scales(cfg, meta)
    shapes = {n: (tuple(t.shape), *rules[n]) for n, t in meta.state_dict().items()}
    return weights.draw(shapes, sub_seed(seed, 1), device)


def reference_model(cfg: dict, seed: int, device) -> ref.PMVQVAE:
    model = ref.build(cfg, device)
    model.load_state_dict(draw_weights(cfg, seed, device))
    return model.eval()


def program_model(cfg: dict, state: dict, device):
    """The program's ``PMVQVAE`` as ``train_pm_vqvae`` builds it (the chain
    mode and compute dtype of the config), holding ``state``. Built on the
    device itself: its initialisers on the meta device would load the
    decompositions' Python modules, seconds of set-up."""
    from posterior_matching_torch.models.pm_vqvae import PMVQVAE

    vq = dict(cfg["vqvae"])
    pc = dict(cfg["pixel_cnn"], num_indices=vq["num_embeddings"],
              image_shape=tuple(cfg["pixel_cnn"]["image_shape"]))
    with torch.device(device):
        model = PMVQVAE(cfg["conditional_dim"], vq, pc, chain_segment=cfg["chain_segment"],
                        compute_dtype=cfg["compute_dtype"])
    model.load_state_dict(state, strict=True)
    return model.eval()


def split(cfg: dict, seed: int, n: int, stream: int, device) -> np.ndarray:
    """``n`` seeded uint8 images of the config's shape, drawn on the device in
    one call and held on the host."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    shape = (n, *cfg["data"]["image_shape"])
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen,
                         device=device).cpu().numpy()


def images(split_u8: np.ndarray, rows, device) -> torch.Tensor:
    """Rows of a split as the data path rescales them: float32(u8) * float32(1/255)."""
    x = torch.from_numpy(np.ascontiguousarray(split_u8[rows])).to(device)
    return x.float() * torch.tensor(U8_SCALE, device=device)
