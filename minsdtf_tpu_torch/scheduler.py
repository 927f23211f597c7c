"""Diffusion noise schedule: tables, timestep selection, and per-step coefficients.

Host-side numpy, a copy of the JAX package's scheduler:

1. :class:`Scheduler` has the reference scheduler's public surface
   (``set_timesteps``, ``step``, ``alphas_cumprod``, ``signal_rates``, ...) for
   the DDIM-like and TCD schedules; :class:`LCMScheduler`,
   :class:`DPMSolverScheduler` (DPM-Solver++(2M), optionally on the Karras
   spacing) and :class:`EulerAncestralScheduler` extend it, each with its host
   ``step``. :func:`make_scheduler` maps a ``scheduler_type`` to one of them.
2. :class:`DenoiseSchedule` holds every per-step scalar the sampling update needs,
   precomputed on the host, so the step loop in :mod:`minsdtf_tpu_torch.sampler`
   reads plain floats. Its ``mode`` names the update the loop applies.
3. :func:`timestep_embedding` on the host for the sampler's fixed timesteps, and
   :func:`timestep_embedding_traced` on a tensor of timesteps drawn per example
   (training), on any device.

Schedule math: "scaled-linear" betas,
``alphas_cumprod = cumprod(1 - linspace(sqrt(b0), sqrt(b1), T)**2)``;
``signal_rates = sqrt(acp)``, ``noise_rates = sqrt(1 - acp)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


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


def karras_timesteps(num_inference_steps: int, alphas_cumprod: np.ndarray,
                     rho: float = 7.0) -> np.ndarray:
    """Karras et al. sigma spacing (arXiv:2206.00364 eq. 5) snapped to the training
    grid: sigmas run from sigma_max to sigma_min evenly in sigma^(1/rho), and each
    is snapped to the nearest timestep of sigma(t) = sqrt((1-acp)/acp), with
    collisions pushed down so that the schedule strictly descends."""
    sigmas_all = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    sig_min, sig_max = float(sigmas_all[0]), float(sigmas_all[-1])
    ramp = np.linspace(0, 1, num_inference_steps)
    s = (sig_max ** (1 / rho) + ramp * (sig_min ** (1 / rho) - sig_max ** (1 / rho))) ** rho
    idx = np.searchsorted(sigmas_all, s).clip(1, len(sigmas_all) - 1)
    left = np.abs(sigmas_all[idx - 1] - s) <= np.abs(sigmas_all[idx] - s)
    ts = np.where(left, idx - 1, idx).astype(np.int64)
    for i in range(1, len(ts)):
        if ts[i] >= ts[i - 1]:
            ts[i] = ts[i - 1] - 1
    if ts[-1] < 0:
        raise ValueError(f"karras grid collapsed at {num_inference_steps} steps")
    return ts.astype(np.int32)


class Scheduler:
    """Host-side scheduler with the reference's public surface.

    ``step`` is the reference's host update; the sampler uses
    :class:`DenoiseSchedule` instead. ``mode`` is "tcd" or "ddim" here, and the
    subclasses' own name otherwise.
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
        self.mode = "tcd" if active_tcd else "ddim"
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


class LCMScheduler(Scheduler):
    """Latent Consistency Model sampler (arXiv:2310.04378) on TCD's timestep grid.
    With ``st = t * timestep_scaling``:

        c_skip = sigma_data^2 / (st^2 + sigma_data^2)
        c_out  = st / sqrt(st^2 + sigma_data^2)
        denoised = c_out * pred_x0 + c_skip * latent_prev
        x' = last ? denoised : sr_prev * denoised + nr_prev * z   (fresh z per step)
    """

    def __init__(self, *args, sigma_data: float = 0.5, timestep_scaling: float = 10.0,
                 **kwargs):
        kwargs["active_tcd"] = True  # the TCD timestep grid
        super().__init__(*args, **kwargs)
        self.mode = "lcm"
        self.sigma_data = float(sigma_data)
        self.timestep_scaling = float(timestep_scaling)

    def boundary_scalings(self, timestep):
        st = np.asarray(timestep, np.float64) * self.timestep_scaling
        c_skip = self.sigma_data**2 / (st**2 + self.sigma_data**2)
        c_out = st / np.sqrt(st**2 + self.sigma_data**2)
        return c_skip, c_out

    def step(self, latent: np.ndarray, timestep: int, latent_prev: np.ndarray,
             eta: float = 0.3):
        """``eta`` is ignored: LCM re-noises fully between steps."""
        if self.num_inference_steps is None:
            raise ValueError("Call `set_timesteps` before `step`.")
        if self.step_index is None:
            self._init_step_index(timestep)
        i = self.step_index
        is_last = i == self.num_inference_steps - 1
        prev_t = int(self.timesteps[i + 1]) if i + 1 < len(self.timesteps) else 0

        sr_t = self.signal_rates[timestep]
        nr_t = self.noise_rates[timestep]
        pred_x0 = (latent_prev - nr_t * latent) / sr_t
        c_skip, c_out = self.boundary_scalings(timestep)
        denoised = c_out * pred_x0 + c_skip * latent_prev
        if is_last:
            out = denoised
        else:
            noise = np.random.randn(*latent.shape).astype(np.float32)
            out = self.signal_rates[prev_t] * denoised + self.noise_rates[prev_t] * noise
        self._step_index += 1
        return out


class DPMSolverScheduler(Scheduler):
    """DPM-Solver++(2M) (arXiv:2211.01095, data prediction) on the DDIM grid, or on
    the Karras spacing with ``karras_sigmas``. Per step, with
    ``lambda(t) = ln(signal_rate / noise_rate)`` and ``h = lambda_prev - lambda_t``:

        x0     = (x - nr_t * eps) / sr_t
        D      = (1 + w) * x0 - w * x0_prev,  w = h / (2 * h_prev)
        x_prev = (nr_prev / nr_t) * x + sr_prev * (1 - exp(-h)) * D

    The first step has no ``x0_prev`` (w = 0: the DDIM update). The last step goes
    to the clean boundary (noise rate 0), where the update is ``x = x0``.
    """

    def __init__(self, *args, karras_sigmas: bool = False, **kwargs):
        kwargs["active_tcd"] = False
        super().__init__(*args, **kwargs)
        self.mode = "dpm"
        self.karras_sigmas = bool(karras_sigmas)
        self._prev_x0 = None
        self._prev_h = None

    def set_timesteps(self, num_inference_steps=None, **kwargs):
        super().set_timesteps(num_inference_steps, **kwargs)
        if self.karras_sigmas and num_inference_steps is not None:
            self.timesteps = karras_timesteps(num_inference_steps, self.alphas_cumprod)

    def _lambda(self, t: int) -> float:
        return float(np.log(self.signal_rates[t] / self.noise_rates[t]))

    def step(self, latent: np.ndarray, timestep: int, latent_prev: np.ndarray,
             eta: float = 0.3):
        """``eta`` is ignored (deterministic)."""
        if self.num_inference_steps is None:
            raise ValueError("Call `set_timesteps` before `step`.")
        if self.step_index is None:
            self._init_step_index(timestep)
            self._prev_x0 = None
            self._prev_h = None
        i = self.step_index
        is_last = i == self.num_inference_steps - 1

        sr_t = self.signal_rates[timestep]
        nr_t = self.noise_rates[timestep]
        x0 = (latent_prev - nr_t * latent) / sr_t
        if is_last:
            out = x0
            h = None
        else:
            prev_t = int(self.timesteps[i + 1])
            h = self._lambda(prev_t) - self._lambda(timestep)
            if self._prev_x0 is None:
                d = x0
            else:
                w = h / (2.0 * self._prev_h)
                d = (1.0 + w) * x0 - w * self._prev_x0
            out = (self.noise_rates[prev_t] / nr_t) * latent_prev \
                + self.signal_rates[prev_t] * (1.0 - np.exp(-h)) * d
        self._prev_x0 = x0
        self._prev_h = h
        self._step_index += 1
        return out


class EulerAncestralScheduler(Scheduler):
    """Euler-Ancestral ("Euler a"; Karras et al. arXiv:2206.00364 Alg. 2 with the
    ancestral noise split) in VP coordinates. With ``sigma(t) = nr / sr``:

        sigma_up^2 = sig_prev^2 * (sig_t^2 - sig_prev^2) / sig_t^2
        sigma_down = sqrt(sig_prev^2 - sigma_up^2)
        x' = c_x * x + c_d * eps + c_noise * z,
        c_x = sr_prev / sr_t,  c_d = sr_prev * (sigma_down - sig_t),
        c_noise = sr_prev * sigma_up

    The last step returns pred_x0. Plain "euler" is DDIM: on the VP
    eps-prediction parametrization the two updates are the same.
    """

    def __init__(self, *args, **kwargs):
        kwargs["active_tcd"] = False
        super().__init__(*args, **kwargs)
        self.mode = "euler_a"

    def _sigma(self, t: int) -> float:
        return float(self.noise_rates[t] / self.signal_rates[t])

    def step(self, latent: np.ndarray, timestep: int, latent_prev: np.ndarray,
             eta: float = 0.3, noise: Optional[np.ndarray] = None):
        """``eta`` is ignored (the ancestral split fixes the noise level).
        ``noise`` replaces the drawn z."""
        if self.num_inference_steps is None:
            raise ValueError("Call `set_timesteps` before `step`.")
        if self.step_index is None:
            self._init_step_index(timestep)
        i = self.step_index
        is_last = i == self.num_inference_steps - 1

        sr_t = self.signal_rates[timestep]
        nr_t = self.noise_rates[timestep]
        x0 = (latent_prev - nr_t * latent) / sr_t
        if is_last:
            out = x0
        else:
            prev_t = int(self.timesteps[i + 1])
            sig_t, sig_p = self._sigma(timestep), self._sigma(prev_t)
            sig_up2 = sig_p**2 * (sig_t**2 - sig_p**2) / sig_t**2
            sig_up = np.sqrt(max(0.0, sig_up2))
            sig_down = np.sqrt(max(0.0, sig_p**2 - sig_up2))
            sr_prev = self.signal_rates[prev_t]
            z = noise if noise is not None else np.random.randn(*latent.shape).astype(np.float32)
            out = ((sr_prev / sr_t) * latent_prev
                   + sr_prev * (sig_down - sig_t) * latent
                   + sr_prev * sig_up * z)
        self._step_index += 1
        return out


SCHEDULER_TYPES = ("ddim", "euler", "tcd", "lcm", "dpm", "dpm_karras", "euler_a")


def make_scheduler(scheduler_type: Optional[str] = None, active_tcd: bool = False) -> Scheduler:
    """The scheduler for a pipeline's ``scheduler_type``; None means "tcd" with
    ``active_tcd`` and "ddim" without. "euler" is DDIM (see
    :class:`EulerAncestralScheduler`)."""
    if scheduler_type is None:
        scheduler_type = "tcd" if active_tcd else "ddim"
    if scheduler_type == "lcm":
        return LCMScheduler()
    if scheduler_type in ("dpm", "dpm_karras"):
        return DPMSolverScheduler(karras_sigmas=scheduler_type == "dpm_karras")
    if scheduler_type == "euler_a":
        return EulerAncestralScheduler()
    if scheduler_type in ("ddim", "euler", "tcd"):
        return Scheduler(active_tcd=scheduler_type == "tcd")
    raise ValueError(f"unknown scheduler_type {scheduler_type!r}; one of {SCHEDULER_TYPES}")


ROW_KEYS = ("sr_t", "nr_t", "sr_prev", "nr_prev", "sr_s", "nr_s", "c_denoised",
            "c_noise", "c_skip", "c_out", "c_x", "c_d", "w", "is_last")
MODES = ("ddim", "tcd", "lcm", "dpm", "euler_a")


@dataclasses.dataclass(frozen=True)
class DenoiseSchedule:
    """Per-step coefficients, each an (n,) float32 array (timesteps int32).

    The update from row ``i``, given model output ``eps`` and current latent ``x``
    (matches the schedulers' ``step``), by ``mode``:

        x0 = (x - nr_t * eps) / sr_t
        ddim:     x' = last ? x0 : sr_prev * x0 + nr_prev * eps
        tcd:      d  = sr_s * x0 + nr_s * eps
                  x' = (last or eta==0) ? d : c_denoised * d + c_noise * z
        lcm:      d  = c_out * x0 + c_skip * x
                  x' = last ? d : sr_prev * d + nr_prev * z
        dpm:      d  = (1 + w) * x0 - w * x0_prev     (x0 of the step before)
                  x' = c_x * x + c_d * d
        euler_a:  x' = last ? x0 : c_x * x + c_d * eps + c_noise * z
    """

    timesteps: np.ndarray        # (n,) int32, descending: the t fed to the UNet
    sr_t: np.ndarray             # signal_rates[t]
    nr_t: np.ndarray             # noise_rates[t]
    sr_prev: np.ndarray          # signal_rates[prev_t]   (DDIM and LCM)
    nr_prev: np.ndarray          # noise_rates[prev_t]
    sr_s: np.ndarray             # signal_rates[t_s]      (TCD)
    nr_s: np.ndarray             # noise_rates[t_s]
    c_denoised: np.ndarray       # sqrt(a_prev / a_s)     (TCD re-noise mix)
    c_noise: np.ndarray          # TCD: sqrt(1 - a_prev / a_s); Euler-a: sr_prev * sigma_up
    is_last: np.ndarray          # (n,) float32 {0,1}
    active_tcd: bool
    eta: float
    # LCM boundary scalings (zeros unless mode == "lcm")
    c_skip: np.ndarray = None    # sigma_d^2 / (st^2 + sigma_d^2)
    c_out: np.ndarray = None     # st / sqrt(st^2 + sigma_d^2)
    # DPM-Solver++(2M) and Euler-a coefficients (zeros in the other modes)
    c_x: np.ndarray = None       # dpm: nr_prev / nr_t (0 on the last step); euler_a: sr_prev / sr_t
    c_d: np.ndarray = None       # dpm: sr_prev * (1 - exp(-h)) (1 on the last step);
                                 # euler_a: sr_prev * (sigma_down - sig_t)
    w: np.ndarray = None         # dpm: h / (2 h_prev); 0 on the first and last steps
    mode: str = "ddim"           # one of MODES
    # img2img: the timestep at which the init latent is noised (one step above
    # the first iterated step, as in the reference).
    init_timestep: int = 0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    @property
    def rows(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k) for k in ROW_KEYS}


def build_denoise_schedule(
    scheduler: Scheduler,
    num_steps: int,
    strength: Optional[float] = None,
    eta: float = 0.3,
    timesteps: Optional[Sequence[int]] = None,
) -> DenoiseSchedule:
    """Precompute the :class:`DenoiseSchedule` for a generation run:
    ``set_timesteps(num_steps)`` then, for img2img, truncation to the first
    ``int(num_steps*strength + 0.5)`` ascending entries. The rows of each mode are
    built as its scheduler's ``step`` computes them."""
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

    mode = scheduler.mode
    if mode not in MODES:
        raise ValueError(f"unknown scheduler mode {mode!r}; one of {MODES}")
    acp = scheduler.alphas_cumprod
    rows_t, rows = [], {k: [] for k in ROW_KEYS}
    prev_h = None
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
        sig_t = sig_p = sig_up2 = None
        if mode == "euler_a" and not is_last:
            sig_t = float(np.sqrt((1.0 - a_t) / a_t))
            sig_p = float(np.sqrt((1.0 - a_prev) / a_prev))
            sig_up2 = sig_p**2 * (sig_t**2 - sig_p**2) / sig_t**2
            # the ancestral noise: sr_prev * sigma_up
            rows["c_noise"].append(float(np.sqrt(a_prev) * np.sqrt(max(0.0, sig_up2))))
        else:
            rows["c_noise"].append(np.sqrt(max(0.0, 1.0 - a_prev / a_s)))
        if mode == "lcm":
            c_skip, c_out = scheduler.boundary_scalings(t)
            rows["c_skip"].append(float(c_skip))
            rows["c_out"].append(float(c_out))
        else:
            rows["c_skip"].append(0.0)
            rows["c_out"].append(0.0)
        c_x, c_d, w = 0.0, 0.0, 0.0
        if mode == "dpm":
            if is_last:
                # the clean boundary (noise rate 0): x' = x0, first order
                c_d, prev_h = 1.0, None
            else:
                lam_t = np.log(np.sqrt(a_t) / np.sqrt(1.0 - a_t))
                lam_p = np.log(np.sqrt(a_prev) / np.sqrt(1.0 - a_prev))
                h = float(lam_p - lam_t)
                c_x = float(np.sqrt(1.0 - a_prev) / np.sqrt(1.0 - a_t))
                c_d = float(np.sqrt(a_prev) * (1.0 - np.exp(-h)))
                w = 0.0 if prev_h is None else h / (2.0 * prev_h)
                prev_h = h
        elif mode == "euler_a" and not is_last:
            # the last step takes x0 (is_last)
            sig_down = float(np.sqrt(max(0.0, sig_p**2 - sig_up2)))
            c_x = float(np.sqrt(a_prev / a_t))
            c_d = float(np.sqrt(a_prev) * (sig_down - sig_t))
        rows["c_x"].append(c_x)
        rows["c_d"].append(c_d)
        rows["w"].append(w)
        rows["is_last"].append(1.0 if is_last else 0.0)

    return DenoiseSchedule(
        timesteps=np.asarray(rows_t, dtype=np.int32),
        active_tcd=scheduler.active_tcd,
        eta=eta,
        mode=mode,
        init_timestep=init_timestep,
        **{k: np.asarray(v, dtype=np.float32) for k, v in rows.items()},
    )


def timestep_embedding(timesteps, dim: int = 320, max_period: float = 10000.0) -> np.ndarray:
    """Sinusoidal timestep embedding, ``concat([cos, sin])`` ordering, host numpy.
    ``timesteps`` is a scalar or (n,) array."""
    args = np.asarray(timesteps, dtype=np.float32)[..., None] * _frequencies(dim // 2, max_period)
    return np.concatenate([np.cos(args), np.sin(args)], axis=-1).astype(np.float32)


def _frequencies(half: int, max_period: float) -> np.ndarray:
    """``exp(-ln(max_period) * i / half)`` for i < half, from an fp32 ramp (numpy
    gives fp64), as the JAX package computes it on the host."""
    return np.exp(-np.log(max_period) * np.arange(half, dtype=np.float32) / half)


def timestep_embedding_traced(timesteps: torch.Tensor, dim: int = 320,
                              max_period: float = 10000.0) -> torch.Tensor:
    """:func:`timestep_embedding` of an int tensor of timesteps, on its device:
    (B,) -> (B, dim) fp32. The frequencies come from numpy, rounded to fp32, as
    in the JAX package's ``timestep_embedding_traced``; the products, cos and sin
    run on the device."""
    freqs = _device_frequencies(dim // 2, max_period, timesteps.device)
    args = timesteps.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=16)
def _device_frequencies(half: int, max_period: float, device: torch.device) -> torch.Tensor:
    """:func:`_frequencies` in fp32 on ``device``, copied there once: a copy from
    pageable host memory would wait for every kernel queued before it."""
    return torch.from_numpy(_frequencies(half, max_period).astype(np.float32)).to(device)
