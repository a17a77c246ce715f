"""Display rendering of the raycast model maps (port of
kinfu_tpu/pipeline/render.py).

Parity: kernel_renderPhong / kernel_renderNormals of the reference. Its
images are BGR; here channels are RGB, so the Phong diffuse coefficient
triple is reversed to keep the same colour (DIVERGENCES 12). Like the
reference, the eye position is the *world-frame* camera translation while
the vertex map is camera-frame: a frame-mixing quirk kept for pixel parity.

Rounding follows the JAX package so that the uint8 images agree bit for
bit: norms are correctly rounded float32 square roots of the sum of
squares in order (x, y, z), and the specular power is taken in float64 and
rounded to float32 (XLA's float32 `pow` is within an ulp of that; an ulp
moves a uint8 pixel only where it lands on an integer boundary).
"""

from __future__ import annotations

import torch

from kinfu_tpu_torch.numerics import sqrt32

_KD_RGB = (0.580, 0.4745, 0.3843)  # reversed uchar3 kd of the reference
_LIGHT_POS = (500.0, 500.0, -500.0)
_LIGHT_INTENSITY = 0.9
_AMBIENT = 0.1
_SPECULAR = 0.5
_SHININESS = 10.0


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(sqrt32(_dot(v, v)), min=1e-30)[..., None]


def render_phong(eye_t: torch.Tensor, vmap: torch.Tensor, nmap: torch.Tensor) -> torch.Tensor:
    """Blinn-Phong shading -> [H, W, 3] uint8 on the maps' device."""
    valid = (nmap != 0).any(dim=-1) & (vmap != 0).any(dim=-1)
    light = torch.tensor(_LIGHT_POS, dtype=torch.float32, device=vmap.device)
    eye_dir = _normalize(eye_t - vmap)
    light_dir = _normalize(light - vmap)

    light_cos = _dot(nmap, light_dir).abs()
    kd = torch.tensor(_KD_RGB, dtype=torch.float32, device=vmap.device)
    diffuse = kd * (_LIGHT_INTENSITY * light_cos)[..., None]

    h_cos = _dot(nmap, _normalize(light_dir + eye_dir)).abs()
    specular = (_SPECULAR * _LIGHT_INTENSITY * torch.pow(h_cos.double(), _SHININESS).float())

    color = torch.clamp(_AMBIENT + diffuse + specular[..., None], max=1.0)
    out = (color * 255.0).to(torch.uint8)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def render_normals(nmap: torch.Tensor) -> torch.Tensor:
    """abs(n) * 255 false colour -> [H, W, 3] uint8."""
    return (nmap.abs() * 255.0).to(torch.uint8)
