"""Diffusion noise schedule: tables, timestep selection, and per-step coefficients.

Host-side numpy, a copy of the JAX package's scheduler for the DDIM-like and TCD
schedules:

1. :class:`Scheduler` has the reference scheduler's public surface
   (``set_timesteps``, ``step``, ``alphas_cumprod``, ``signal_rates``, ...).
2. :class:`DenoiseSchedule` holds every per-step scalar the sampling update needs,
   precomputed on the host, so the step loop in :mod:`minsdtf_tpu_torch.sampler`
   reads plain floats.

Schedule math: "scaled-linear" betas,
``alphas_cumprod = cumprod(1 - linspace(sqrt(b0), sqrt(b1), T)**2)``;
``signal_rates = sqrt(acp)``, ``noise_rates = sqrt(1 - acp)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


def make_alphas_cumprod(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
) -> np.ndarray:
    """Scaled-linear cumulative alpha table (float64 on host for accuracy)."""
    betas = np.square(
        np.linspace(np.sqrt(beta_start), np.sqrt(beta_end), num_train_timesteps)
    )
    return np.cumprod(1.0 - betas, axis=0)


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """Descending DDIM-like schedule: ``linspace(0, T, n, endpoint=False)`` truncated
    to int32, then reversed."""
    ts = np.linspace(0, num_train_timesteps, num_inference_steps, dtype=np.int32, endpoint=False)
    return ts[::-1].copy()


def tcd_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    original_inference_steps: int = 50,
    strength: float = 1.0,
    arbitrary_grid: bool = False,
) -> np.ndarray:
    """Descending TCD schedule: a floor-linspace subsample of the reversed origin
    grid ``(1..floor(orig*strength)) * k - 1`` with ``k = T // orig``, or of
    ``0..T*strength`` when ``arbitrary_grid``."""
    if arbitrary_grid:
        origin = np.asarray(range(0, int(num_train_timesteps * strength)))
    else:
        k = num_train_timesteps // original_inference_steps
        origin = np.asarray(range(1, int(original_inference_steps * strength) + 1)) * k - 1
    if len(origin) // num_inference_steps < 1:
        raise ValueError(
            f"original_steps*strength ({original_inference_steps}x{strength}) is smaller "
            f"than num_inference_steps ({num_inference_steps})."
        )
    if num_inference_steps > original_inference_steps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) cannot exceed "
            f"original_inference_steps ({original_inference_steps})."
        )
    origin = origin[::-1].copy()
    idx = np.floor(np.linspace(0, len(origin), num=num_inference_steps, endpoint=False)).astype(np.int32)
    return origin[idx].astype(np.int32)


class Scheduler:
    """Host-side scheduler with the reference's public surface.

    ``step`` is the reference's host update; the sampler uses
    :class:`DenoiseSchedule` instead.
    """

    order = 1

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        original_inference_steps: int = 50,
        active_tcd: bool = True,
    ):
        self.active_tcd = active_tcd
        self.num_train_timesteps = num_train_timesteps
        self.original_inference_steps = original_inference_steps
        self.alphas_cumprod = make_alphas_cumprod(num_train_timesteps, beta_start, beta_end)
        self.signal_rates = np.sqrt(self.alphas_cumprod)
        self.noise_rates = np.sqrt(1.0 - self.alphas_cumprod)
        self.final_alpha_cumprod = 1.0
        self.init_noise_sigma = 1.0
        self.num_inference_steps: Optional[int] = None
        self.timesteps = np.arange(0, num_train_timesteps)[::-1].copy().astype(np.int32)
        self.custom_timesteps = False
        self._step_index: Optional[int] = None
        self._begin_index: Optional[int] = None

    @property
    def step_index(self):
        return self._step_index

    @property
    def begin_index(self):
        return self._begin_index

    def set_begin_index(self, begin_index: int = 0):
        self._begin_index = begin_index

    def index_for_timestep(self, timestep, schedule_timesteps=None) -> int:
        if schedule_timesteps is None:
            schedule_timesteps = self.timesteps
        matches = np.nonzero(schedule_timesteps == timestep)[0]
        return int(matches[0])

    def _init_step_index(self, timestep):
        if self._begin_index is None:
            self._step_index = self.index_for_timestep(timestep)
        else:
            self._step_index = self._begin_index

    def set_timesteps(
        self,
        num_inference_steps: Optional[int] = None,
        original_inference_steps: Optional[int] = None,
        timesteps: Optional[List[int]] = None,
        strength: float = 1.0,
    ):
        if (num_inference_steps is None) == (timesteps is None):
            raise ValueError("Pass exactly one of `num_inference_steps` or `timesteps`.")

        if not self.active_tcd:
            self.num_inference_steps = num_inference_steps
            self.timesteps = ddim_timesteps(num_inference_steps, self.num_train_timesteps)
            self._step_index = None
            self._begin_index = None
            return

        if timesteps is not None:
            orig = (original_inference_steps
                    if original_inference_steps is not None else self.original_inference_steps)
            k = self.num_train_timesteps // orig
            train_grid = {i * k - 1 for i in range(1, int(orig * strength) + 1)}
            for i in range(1, len(timesteps)):
                if timesteps[i] >= timesteps[i - 1]:
                    raise ValueError("custom `timesteps` must be in descending order.")
            if timesteps[0] >= self.num_train_timesteps:
                raise ValueError("`timesteps` must start before num_train_timesteps.")
            if strength == 1.0 and timesteps[0] != self.num_train_timesteps - 1:
                print(
                    f"The first custom timestep is {timesteps[0]}, not "
                    f"num_train_timesteps-1 ({self.num_train_timesteps - 1}); results "
                    f"may be unexpected."
                )
            off_grid = [t for t in timesteps[1:] if t not in train_grid]
            if off_grid:
                print(
                    f"Custom timesteps not on the training/distillation schedule: "
                    f"{off_grid}; results may be unexpected."
                )
            if len(timesteps) > orig:
                print(
                    f"Custom schedule length {len(timesteps)} exceeds the "
                    f"distillation schedule length {orig}; results may be unexpected."
                )
            ts = np.array(timesteps, dtype=np.int32)
            self.num_inference_steps = len(ts)
            self.custom_timesteps = True
            init_timestep = min(int(self.num_inference_steps * strength), self.num_inference_steps)
            t_start = max(self.num_inference_steps - init_timestep, 0)
            self.timesteps = ts[t_start * self.order:]
        else:
            if num_inference_steps > self.num_train_timesteps:
                raise ValueError(
                    f"num_inference_steps ({num_inference_steps}) > num_train_timesteps"
                    f" ({self.num_train_timesteps})."
                )
            orig = (
                original_inference_steps
                if original_inference_steps is not None
                else self.original_inference_steps
            )
            self.num_inference_steps = num_inference_steps
            self.timesteps = tcd_timesteps(
                num_inference_steps, self.num_train_timesteps, orig, strength,
                # an explicitly passed original_inference_steps selects the
                # reference's arbitrary-timestep origin grid
                arbitrary_grid=original_inference_steps is not None,
            )
        self._step_index = None
        self._begin_index = None

    def step(self, latent: np.ndarray, timestep: int, latent_prev: np.ndarray, eta: float = 0.3):
        """Reference step convention: ``latent`` is the model output (eps),
        ``latent_prev`` the current latent x."""
        if self.num_inference_steps is None:
            raise ValueError("Call `set_timesteps` before `step`.")
        if self.step_index is None:
            self._init_step_index(timestep)
        if not 0 <= eta <= 1.0:
            raise ValueError("eta (gamma) must be in [0, 1]")

        i = self.step_index
        is_last = i == self.num_inference_steps - 1
        if i + 1 < len(self.timesteps):
            prev_t = int(self.timesteps[i + 1])
        else:
            prev_t = 0 if self.active_tcd else int(timestep)

        sr_t = self.signal_rates[timestep]
        nr_t = self.noise_rates[timestep]
        pred_x0 = (latent_prev - nr_t * latent) / sr_t

        if self.active_tcd:
            t_s = int(np.floor((1.0 - eta) * prev_t))
            a_s = self.alphas_cumprod[t_s]
            denoised = np.sqrt(a_s) * pred_x0 + np.sqrt(1.0 - a_s) * latent
            if eta > 0.0 and not is_last:
                a_prev = self.alphas_cumprod[prev_t]
                noise = np.random.randn(*latent.shape).astype(np.float32)
                out = np.sqrt(a_prev / a_s) * denoised + np.sqrt(1.0 - a_prev / a_s) * noise
            else:
                out = denoised
        else:
            if is_last:
                out = pred_x0
            else:
                out = self.signal_rates[prev_t] * pred_x0 + self.noise_rates[prev_t] * latent

        self._step_index += 1
        return out

    def __len__(self):
        return self.num_train_timesteps


ROW_KEYS = ("sr_t", "nr_t", "sr_prev", "nr_prev", "sr_s", "nr_s", "c_denoised",
            "c_noise", "is_last")


@dataclasses.dataclass(frozen=True)
class DenoiseSchedule:
    """Per-step coefficients, each an (n,) float32 array (timesteps int32).

    The update from row ``i``, given model output ``eps`` and current latent ``x``
    (matches :meth:`Scheduler.step`):

        x0 = (x - nr_t * eps) / sr_t
        DDIM-like:  x' = last ? x0 : sr_prev * x0 + nr_prev * eps
        TCD:        d  = sr_s * x0 + nr_s * eps
                    x' = (last or eta==0) ? d : c_denoised * d + c_noise * z
    """

    timesteps: np.ndarray        # (n,) int32, descending: the t fed to the UNet
    sr_t: np.ndarray             # signal_rates[t]
    nr_t: np.ndarray             # noise_rates[t]
    sr_prev: np.ndarray          # signal_rates[prev_t]   (DDIM branch)
    nr_prev: np.ndarray          # noise_rates[prev_t]
    sr_s: np.ndarray             # signal_rates[t_s]      (TCD branch)
    nr_s: np.ndarray             # noise_rates[t_s]
    c_denoised: np.ndarray       # sqrt(a_prev / a_s)     (TCD re-noise mix)
    c_noise: np.ndarray          # sqrt(1 - a_prev / a_s)
    is_last: np.ndarray          # (n,) float32 {0,1}
    active_tcd: bool
    eta: float
    # img2img: the timestep at which the init latent is noised (one step above
    # the first iterated step, as in the reference).
    init_timestep: int = 0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def build_denoise_schedule(
    scheduler: Scheduler,
    num_steps: int,
    strength: Optional[float] = None,
    eta: float = 0.3,
    timesteps: Optional[Sequence[int]] = None,
) -> DenoiseSchedule:
    """Precompute the :class:`DenoiseSchedule` for a generation run:
    ``set_timesteps(num_steps)`` then, for img2img, truncation to the first
    ``int(num_steps*strength + 0.5)`` ascending entries."""
    scheduler.set_timesteps(num_inference_steps=None if timesteps is not None else num_steps,
                            timesteps=list(timesteps) if timesteps is not None else None)
    full = scheduler.timesteps.astype(np.int64)  # descending
    n = len(full)
    if strength is not None and 0.0 < strength < 1.0:
        k = int(num_steps * strength + 0.5)
        start = max(0, n - k)
    else:
        start = 0
    # the reference indexes out of bounds when k == n: clamp to the top of the schedule
    init_timestep = int(full[start - 1]) if start > 0 else int(full[0])

    acp = scheduler.alphas_cumprod
    rows_t, rows = [], {k: [] for k in ROW_KEYS}
    for i in range(start, n):
        t = int(full[i])
        is_last = i == n - 1
        prev_t = int(full[i + 1]) if i + 1 < n else (0 if scheduler.active_tcd else t)
        a_t = acp[t]
        a_prev = acp[prev_t]
        t_s = int(np.floor((1.0 - eta) * prev_t))
        a_s = acp[t_s]
        rows_t.append(t)
        rows["sr_t"].append(np.sqrt(a_t))
        rows["nr_t"].append(np.sqrt(1.0 - a_t))
        rows["sr_prev"].append(np.sqrt(a_prev))
        rows["nr_prev"].append(np.sqrt(1.0 - a_prev))
        rows["sr_s"].append(np.sqrt(a_s))
        rows["nr_s"].append(np.sqrt(1.0 - a_s))
        rows["c_denoised"].append(np.sqrt(a_prev / a_s))
        rows["c_noise"].append(np.sqrt(max(0.0, 1.0 - a_prev / a_s)))
        rows["is_last"].append(1.0 if is_last else 0.0)

    return DenoiseSchedule(
        timesteps=np.asarray(rows_t, dtype=np.int32),
        active_tcd=scheduler.active_tcd,
        eta=eta,
        init_timestep=init_timestep,
        **{k: np.asarray(v, dtype=np.float32) for k, v in rows.items()},
    )


def timestep_embedding(timesteps, dim: int = 320, max_period: float = 10000.0) -> np.ndarray:
    """Sinusoidal timestep embedding, ``concat([cos, sin])`` ordering, host numpy.
    ``timesteps`` is a scalar or (n,) array."""
    half = dim // 2
    freqs = np.exp(-np.log(max_period) * np.arange(half, dtype=np.float32) / half)
    args = np.asarray(timesteps, dtype=np.float32)[..., None] * freqs
    return np.concatenate([np.cos(args), np.sin(args)], axis=-1).astype(np.float32)
