"""Plain float32 reference of Extract and Structuralize: from a song's
samples to the hFT's note maps and the Beat-Transformer's activations, with
the peak picker and the DBN decoder that turn them into notes and beats.

Everything is worked out again from the samples and the exported
parameters (`params.npz`, JAX layout: a linear's `w` is [in, out], a
convolution's `w` is [kh, kw, in, out]): the 16 kHz resample (scipy's
polyphase filter), the log-mel, the segments, the separation spectrogram,
masks and dB-mel features. The forwards run in float32 with TF32 off,
attention in its explicit form (the dilated attention as shifted slices),
with no kernel of the program. `cast`, applied to every matmul and
convolution operand, is the precision control's hook.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Cast = Callable[[torch.Tensor], torch.Tensor]


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def load_params(path, device) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].astype(np.float32)).to(device) for k in z.files}


# ---- filterbanks (librosa's and torchaudio's conventions) ------------------
def _hz_to_mel(f, scale):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    f / (200.0 / 3.0))


def _mel_to_hz(m, scale):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3.0))


def mel_filterbank(sr, n_fft, n_mels, fmin, fmax, scale) -> np.ndarray:
    """Triangular filters [n_fft // 2 + 1, n_mels], Slaney-normalised."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale),
                                   n_mels + 2), scale)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / np.maximum(f_pts[1:-1] - f_pts[:-2], 1e-10)
    up = slopes[:, 2:] / np.maximum(f_pts[2:] - f_pts[1:-1], 1e-10)
    fb = np.maximum(0.0, np.minimum(down, up)) * (2.0 / (f_pts[2:] - f_pts[:-2]))[None]
    return fb


def _hann(n: int) -> np.ndarray:
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))   # periodic


def _reflect(wave: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(wave, pad, mode="reflect" if len(wave) > pad else "constant")


def power_frames(wave: np.ndarray, n_fft: int, hop: int, n_frames: int, device) -> torch.Tensor:
    """|rFFT|² of Hann-windowed frames [n_frames, n_fft // 2 + 1], in float64."""
    x = torch.from_numpy(np.asarray(wave, np.float64)).to(device)
    frames = x.unfold(0, n_fft, hop)[:n_frames] * torch.from_numpy(_hann(n_fft)).to(device)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


# ---- small pieces ----------------------------------------------------------
def _ln(x, p, name, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}/scale"], p[f"{name}/bias"], eps)


def _lin(x, p, name, cast: Cast):
    return cast(x) @ cast(p[f"{name}/w"]) + p[f"{name}/b"]


def _mha(q_in, kv_in, p, name, heads, cast: Cast):
    N, Lq, H = q_in.shape
    d = H // heads
    q = _lin(q_in, p, f"{name}/q", cast).view(N, Lq, heads, d).transpose(1, 2)
    k = _lin(kv_in, p, f"{name}/k", cast).view(N, -1, heads, d).transpose(1, 2)
    v = _lin(kv_in, p, f"{name}/v", cast).view(N, -1, heads, d).transpose(1, 2)
    probs = torch.softmax(cast(q) @ cast(k).transpose(-1, -2) / math.sqrt(d), dim=-1)
    ctx = (cast(probs) @ cast(v)).transpose(1, 2).reshape(N, Lq, H)
    return _lin(ctx, p, f"{name}/o", cast)


def _layer(p, prefix, l):
    """The parameters of layer `l` of a stacked group, under short names."""
    n = len(prefix) + 1
    return {k[n:]: v[l] for k, v in p.items() if k.startswith(prefix + "/")}


# ---- Extract: the hFT --------------------------------------------------------
@dataclasses.dataclass
class HFTSettings:
    sr: int
    n_fft: int
    hop: int
    n_mels: int
    margin: int
    n_frame: int
    hid: int
    enc_heads: int
    dec_heads: int
    log_offset: float = 1e-8
    min_value: float = -18.0      # the log-mel of silence, padding the segments


def hft_log_mel(wave16k: np.ndarray, s: HFTSettings, device) -> torch.Tensor:
    """[frames, n_mels] log-mel of the 16 kHz wave (centred frames)."""
    n = len(wave16k)
    n_frames = n // s.hop + 1
    padded = _reflect(np.asarray(wave16k, np.float64), s.n_fft // 2)
    padded = np.pad(padded, (0, max(0, (n_frames - 1) * s.hop + s.n_fft - len(padded))))
    power = power_frames(padded, s.n_fft, s.hop, n_frames, device)
    fb = torch.from_numpy(mel_filterbank(s.sr, s.n_fft, s.n_mels, 0.0, s.sr / 2.0,
                                         "htk")).to(device)
    return torch.log(power @ fb + s.log_offset).float()


def hft_segments(feature: torch.Tensor, s: HFTSettings) -> torch.Tensor:
    """[n_seg, n_bin, margin + n_frame + margin] windows of the log-mel."""
    T, n_bin = feature.shape
    n_seg = max(-(-T // s.n_frame), 1)
    full = torch.full((2 * s.margin + n_seg * s.n_frame, n_bin), s.min_value,
                      device=feature.device)
    full[s.margin:s.margin + T] = feature
    return full.unfold(0, 2 * s.margin + s.n_frame, s.n_frame)


def hft_forward(spec: torch.Tensor, p: Dict[str, torch.Tensor], s: HFTSettings,
                cast: Cast = _identity) -> Dict[str, torch.Tensor]:
    """spec [B, n_bin, margin + n_frame + margin] → the time branch's onset,
    offset and frame sigmoids [B, n_frame, n_note]."""
    B, n_bin, _ = spec.shape
    H, T, n_proc = s.hid, s.n_frame, 2 * s.margin + 1
    # The window convolution (C channels of K taps) and the token embedding
    # over its C x (n_proc - K + 1) outputs, as one linear map per window.
    kern, conv_b = p["conv/w"], p["conv/b"]
    C, K = kern.shape
    out_len = n_proc - K + 1
    windows = spec.transpose(1, 2).unfold(1, n_proc, 1)            # [B, T, bin, n_proc]
    conv = torch.stack([sum(windows[..., t:t + out_len] * kern[c, t] for t in range(K))
                        + conv_b[c] for c in range(C)], dim=-2)    # [B, T, bin, C, out]
    x = cast(conv.reshape(B, T, n_bin, C * out_len)) @ cast(p["tok_emb/w"]) + p["tok_emb/b"]
    x = x * math.sqrt(H) + p["freq_pos_emb"]

    def enc_layer(x, lp, heads):
        x = _ln(x + _mha(x, x, lp, "attn", heads, cast), lp, "ln1")
        ff = _lin(torch.relu(_lin(x, lp, "ff/in", cast)), lp, "ff/out", cast)
        return _ln(x + ff, lp, "ln2")

    enc = x.reshape(B * T, n_bin, H)
    for l in range(p["enc_layers/ln1/scale"].shape[0]):
        enc = enc_layer(enc, _layer(p, "enc_layers", l), s.enc_heads)
    q = p["note_query"][None].expand(B * T, -1, -1)
    z = _layer(p, "dec_zero", 0)
    q = _ln(q + _mha(q, enc, z, "cross", s.dec_heads, cast), z, "ln1")
    q = _ln(q + _lin(torch.relu(_lin(q, z, "ff/in", cast)), z, "ff/out", cast), z, "ln2")
    for l in range(p["dec_layers/ln1/scale"].shape[0]):
        lp = _layer(p, "dec_layers", l)
        q = _ln(q + _mha(q, q, lp, "self", s.dec_heads, cast), lp, "ln1")
        q = _ln(q + _mha(q, enc, lp, "cross", s.dec_heads, cast), lp, "ln2")
        q = _ln(q + _lin(torch.relu(_lin(q, lp, "ff/in", cast)), lp, "ff/out", cast),
                lp, "ln3")
    n_note = q.shape[1]
    y = q.reshape(B, T, n_note, H).transpose(1, 2).reshape(B * n_note, T, H)
    y = y * math.sqrt(H) + p["time_pos_emb"][:T]
    for l in range(p["time_layers/ln1/scale"].shape[0]):
        y = enc_layer(y, _layer(p, "time_layers", l), s.dec_heads)
    y = y.reshape(B, n_note, T, H).transpose(1, 2)
    return {head: torch.sigmoid((y @ p[f"heads_time/{head}/w"])[..., 0]
                                + p[f"heads_time/{head}/b"])
            for head in ("onset", "offset", "mpe")}


def hft_maps(wave16k: np.ndarray, p, s: HFTSettings, device, cast: Cast = _identity,
             batch: int = 4) -> Dict[str, np.ndarray]:
    """The song's time-branch maps [n_seg * n_frame, n_note], on the host."""
    segments = hft_segments(hft_log_mel(wave16k, s, device), s)
    parts: Dict[str, List[torch.Tensor]] = {"onset": [], "offset": [], "mpe": []}
    for i in range(0, segments.shape[0], batch):
        out = hft_forward(segments[i:i + batch], p, s, cast)
        for k in parts:
            parts[k].append(out[k].reshape(-1, out[k].shape[-1]).cpu())
    return {k: torch.cat(v).numpy() for k, v in parts.items()}


# ---- Structuralize: separation features --------------------------------------
@dataclasses.dataclass
class SeparationSettings:
    sr: int
    n_fft: int
    hop: int
    n_mels: int
    fmin: float
    fmax: float
    freq_bins: int
    depth: int
    bucket: int = 2048            # frames are padded to a multiple of this
    top_db: float = 80.0


def _conv(h, p, name, cast: Cast, stride=1, norm=True):
    w = p[f"{name}/w"].permute(3, 2, 0, 1)
    out = F.conv2d(cast(h), cast(w), p[f"{name}/b"], stride=stride, padding=w.shape[-1] // 2)
    if norm:
        C = out.shape[1]
        g = next(d for d in range(min(8, C), 0, -1) if C % d == 0)
        out = F.group_norm(out, g, p[f"{name}/gn_scale"], p[f"{name}/gn_bias"], eps=1e-5)
    return out


def _glu(h):
    a, b = h.chunk(2, dim=1)
    return a * torch.sigmoid(b)


def separator_masks(mag_in: torch.Tensor, p, s: SeparationSettings,
                    cast: Cast = _identity) -> torch.Tensor:
    """[T, F] normalised log-magnitudes → ratio masks [stems, T, F]."""
    T, Fq = mag_in.shape
    band = min(Fq, s.freq_bins)
    mult = 2 ** s.depth
    h = F.pad(mag_in[:, :band], (0, (-band) % mult, 0, (-T) % mult))[None, None]
    skips = []
    for i in range(s.depth):
        skips.append(h)
        h = _glu(_conv(h, p, f"enc/{i}/down", cast, stride=2))
        h = _glu(_conv(h, p, f"enc/{i}/ref", cast))
    for i, skip in enumerate(reversed(skips)):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = _glu(_conv(h, p, f"dec/{i}/up", cast))
        h = _glu(_conv(torch.cat([h, skip], dim=1), p, f"dec/{i}/merge", cast))
    masks = torch.softmax(_conv(h, p, "mask_head", cast, norm=False), dim=1)[0, :, :T, :band]
    stems = masks.shape[0]
    if band < Fq:
        masks = torch.cat([masks, masks.new_full((stems, T, Fq - band), 1.0 / stems)], dim=-1)
    return masks


def separation_features(wave44k: np.ndarray, p, s: SeparationSettings, device,
                        cast: Cast = _identity) -> torch.Tensor:
    """The beat model's input [stems, true_frames, n_mels] in dB (each stem
    against its own peak over the true frames, floored `top_db` below)."""
    true_frames = 1 + len(wave44k) // s.hop
    frames = -(-true_frames // s.bucket) * s.bucket
    padded = _reflect(np.asarray(wave44k, np.float64), s.n_fft // 2)
    padded = np.pad(padded, (0, max(0, (frames - 1) * s.hop + s.n_fft - len(padded))))
    mag = power_frames(padded, s.n_fft, s.hop, frames, device).sqrt().float()
    rms = mag[:true_frames].square().sum().div(true_frames * mag.shape[1]).sqrt()
    masks = separator_masks(torch.log1p(mag / rms.clamp_min(1e-6)), p, s, cast)
    fb = torch.from_numpy(mel_filterbank(s.sr, s.n_fft, s.n_mels, s.fmin, s.fmax,
                                         "slaney")).float().to(device)
    mel = torch.einsum("stf,fm->stm", (masks * mag[None]).square(), fb)[:, :true_frames]
    mel = mel.clamp_min(1e-10)
    ref = mel.amax(dim=(1, 2), keepdim=True)
    db = 10.0 * torch.log10(mel) - 10.0 * torch.log10(ref)
    return torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - s.top_db)


# ---- Structuralize: the Beat-Transformer --------------------------------------
@dataclasses.dataclass
class BeatSettings:
    heads: int
    attn_len: int
    instr_layers: Tuple[int, ...]
    bucket: int
    # the dilated heads' slot shifts (4 centred, 4 shifted by -2, -1, 1, 2)
    head_shifts: Tuple[int, ...] = (0, 0, 0, 0, -2, -1, 1, 2)
    pad_db: float = -80.0         # the dB of the frames padded to the bucket


def settings(config: dict) -> Tuple[HFTSettings, SeparationSettings, BeatSettings]:
    """The three stages' sizes from the configuration file."""
    h, s, b = config["hft"], config["separator"], config["beat_model"]
    return (HFTSettings(sr=h["sample_rate"], n_fft=h["n_fft"], hop=h["hop"],
                        n_mels=h["mel_bins"], margin=h["margin"], n_frame=h["num_frame"],
                        hid=h["hid_dim"], enc_heads=h["encoder_n_head"],
                        dec_heads=h["decoder_n_head"]),
            SeparationSettings(sr=s["sample_rate"], n_fft=s["n_fft"], hop=s["hop"],
                               n_mels=s["mel_bins"], fmin=s["mel_fmin"], fmax=s["mel_fmax"],
                               freq_bins=s["freq_bins"], depth=s["depth"]),
            BeatSettings(heads=b["nhead"], attn_len=b["attn_len"],
                         instr_layers=tuple(b["instr_layers"]), bucket=b["frame_bucket"]))


def dilated_attention(q, k, v, er, dilation: int, shifts: Sequence[int],
                      cast: Cast = _identity):
    """Each query attends to `attn_len` keys spaced `dilation` apart, centred
    on it and moved by its head's shift, plus a learnt score per slot
    (q·er); keys past either end are left out. q, k, v [N, H, T, d]."""
    N, H, T, d = q.shape
    A = er.shape[-1]
    offsets = np.stack([np.arange(A) + sh - A // 2 for sh in shifts[:H]])   # [H, A]
    pad = int(np.abs(offsets).max()) * dilation
    kp, vp = F.pad(cast(k), (0, 0, pad, pad)), F.pad(cast(v), (0, 0, pad, pad))

    def slot(src, a):
        return torch.stack([src[:, h, pad + int(offsets[h, a]) * dilation:
                                pad + int(offsets[h, a]) * dilation + T] for h in range(H)],
                           dim=1)

    qc = cast(q)
    scores = torch.stack([(qc * slot(kp, a)).sum(-1) for a in range(A)])      # [A, N, H, T]
    scores = scores + torch.einsum("nhtd,hda->anht", qc, cast(er))
    key_pos = np.arange(T)[None, None] + offsets.T[:, :, None] * dilation     # [A, H, T]
    valid = torch.from_numpy((key_pos >= 0) & (key_pos < T))[:, None].to(q.device)
    probs = torch.softmax((scores / math.sqrt(d)).masked_fill(~valid, float("-inf")), dim=0)
    probs = torch.nan_to_num(probs, nan=0.0)
    return sum(cast(probs[a])[..., None] * slot(vp, a) for a in range(A))


def beat_activations(features: torch.Tensor, p, s: BeatSettings,
                     cast: Cast = _identity) -> np.ndarray:
    """[stems, T, mel] dB features → (beat, downbeat) sigmoids [T, 2]."""
    instr, T, mel = features.shape
    target = max(-(-T // s.bucket) * s.bucket, s.bucket)
    x = F.pad(features, (0, 0, 0, target - T), value=s.pad_db)

    def block(h, name, pad_h):
        w = p[f"{name}/w"].permute(3, 2, 0, 1)
        h = F.conv2d(cast(h), cast(w), p[f"{name}/b"], padding=(pad_h, 0))
        return torch.relu(F.max_pool2d(h, (1, 3), (1, 3)))

    h = block(block(block(x[:, None], "conv1", 2), "conv2", 0), "conv3", 1)
    h = h[..., 0].transpose(1, 2)                                       # [instr, T', D]
    D = h.shape[-1]
    H, d = s.heads, D // s.heads
    n_layers = len({k.split("/")[1] for k in p if k.startswith("layers/")})
    for idx in range(n_layers):
        lp = _layer_flat(p, f"layers/{idx}")
        a_in = _ln(h, lp, "ln1")

        def heads(name, a_in=a_in, lp=lp):
            return _lin(a_in, lp, name, cast).reshape(instr, -1, H, d).transpose(1, 2)

        sa = dilated_attention(heads("q"), heads("k"), heads("v"), lp["er"], 2 ** idx,
                               s.head_shifts, cast).transpose(1, 2).reshape(instr, -1, D)
        h = h + sa
        h = h + _lin(F.gelu(_lin(_ln(h, lp, "ln2"), lp, "ff1", cast)), lp, "ff2", cast)
        if idx in s.instr_layers:
            ip = _layer_flat(lp, "instr")
            hi = h.transpose(0, 1)                                      # [T', instr, D]
            a = _ln(hi, ip, "ln1")

            def iheads(name, a=a, ip=ip):
                return _lin(a, ip, name, cast).reshape(-1, instr, H, d).transpose(1, 2)

            qi, ki, vi = iheads("q"), iheads("k"), iheads("v")
            probs = torch.softmax(cast(qi) @ cast(ki).transpose(-1, -2) / math.sqrt(d), dim=-1)
            ctx = (cast(probs) @ cast(vi)).transpose(1, 2).reshape(-1, instr, D)
            hi = hi + _lin(ctx, ip, "o", cast)
            hi = hi + _lin(torch.relu(_lin(_ln(hi, ip, "ln2"), ip, "ff1", cast)), ip, "ff2",
                           cast)
            h = hi.transpose(0, 1)
    out = torch.relu(h).mean(dim=0) @ p["out/w"] + p["out/b"]
    return torch.sigmoid(out)[:T].cpu().numpy()


def _layer_flat(p, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


# ---- the host decoders ---------------------------------------------------------
def detect_peaks(act: np.ndarray, thr: float, hop_sec: float):
    """Plateau-aware local maxima at or above `thr`, each time interpolated
    between its neighbours: (frames, seconds)."""
    T = len(act)
    if T == 0:
        return np.empty(0, np.int64), np.empty(0, np.float64)
    change = np.flatnonzero(act[1:] != act[:-1])
    run_starts = np.concatenate([[0], change + 1])
    run_vals = act[run_starts]
    prev_vals = np.concatenate([[-np.inf], run_vals[:-1]])
    next_vals = np.concatenate([run_vals[1:], [-np.inf]])
    run_is_peak = (run_vals >= thr) & (prev_vals < run_vals) & (next_vals < run_vals)
    run_id = np.zeros(T, np.int64)
    run_id[run_starts[1:]] = 1
    locs = np.flatnonzero(run_is_peak[np.cumsum(run_id)])
    if len(locs) == 0:
        return locs, np.empty(0, np.float64)
    times = locs.astype(np.float64) * hop_sec
    interior = (locs > 0) & (locs < T - 1)
    li = locs[interior]
    if len(li):
        a_c, a_l, a_r = act[li], act[li - 1], act[li + 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            shift_l = hop_sec * 0.5 * (a_l - a_r) / (a_c - a_r)
            shift_r = hop_sec * 0.5 * (a_r - a_l) / (a_c - a_l)
        t = li * hop_sec
        times[interior] = np.where(a_l > a_r, t - shift_l, np.where(a_l < a_r, t + shift_r, t))
    return locs, times


def maps_to_notes(onset, offset, mpe, velocity, *, hop_sec, note_min, thred_onset,
                  thred_offset, thred_mpe, min_duration) -> List[Dict]:
    """Notes from the time branch's maps: an onset peak starts a note, which
    ends at the first offset peak after it or the first frame below the
    frame threshold, whichever is earlier (bounded by the next onset); a
    zero velocity drops it; an overlapped earlier note of the same pitch is
    cut at the next onset; notes shorter than `min_duration` are dropped."""
    T, n_note = onset.shape
    notes: List[Dict] = []
    for j in range(n_note):
        on_locs, on_times = detect_peaks(onset[:, j], thred_onset, hop_sec)
        if len(on_locs) == 0:
            continue
        off_locs, off_times = detect_peaks(offset[:, j], thred_offset, hop_sec)
        below = np.where(mpe[:, j] < thred_mpe, np.arange(T), T)
        next_below = np.minimum.accumulate(below[::-1])[::-1]
        last = None
        for k in range(len(on_locs)):
            loc_on, t_on = int(on_locs[k]), float(on_times[k])
            if k + 1 < len(on_locs):
                loc_next, t_next = int(on_locs[k + 1]), float(on_times[k + 1])
            else:
                loc_next, t_next = T, (T - 1) * hop_sec
            i = int(np.searchsorted(off_locs, loc_on, side="right"))
            has_off = i < len(off_locs)
            if has_off:
                loc_off, t_off = int(off_locs[i]), float(off_times[i])
                if loc_off > loc_next:
                    loc_off, t_off = loc_next, t_next
            else:
                loc_off, t_off = loc_on + 1, 0.0
            start = min(loc_on + 1, T)
            cand = int(next_below[start]) if start < T else T
            has_mpe = cand < loc_next
            loc_mpe = cand if has_mpe else loc_on + 1
            t_mpe = loc_mpe * hop_sec
            if not has_off and not has_mpe:
                end = t_next
            elif has_off and not has_mpe:
                end = t_off
            elif not has_off:
                end = t_mpe
            else:
                end = t_off if loc_off <= loc_mpe else t_mpe
            vel = int(velocity[loc_on, j])
            if vel <= 0:
                continue
            notes.append({"pitch": int(j + note_min), "onset": t_on, "offset": float(end),
                          "velocity": vel})
            if last is not None and notes[last]["offset"] > notes[-1]["onset"]:
                notes[last]["offset"] = notes[-1]["onset"]
            last = len(notes) - 1
    notes.sort(key=lambda n: (n["onset"], n["pitch"]))
    return [{k: n[k] for k in ("onset", "offset", "pitch", "velocity")}
            for n in notes if n["offset"] - n["onset"] >= min_duration]


TRANSITION_LAMBDA = 100.0
OBSERVATION_LAMBDA = 16.0
EPS = 1e-20


class _BarPointer:
    """The beat-tracking state space: for every integer beat interval
    (frames) a chain of phase states, `blocks` beats to a bar; tempo changes
    only at a beat boundary, with log probability from exp(-λ |to/from - 1|)."""

    def __init__(self, intervals: np.ndarray, blocks: int):
        self.intervals, self.blocks = intervals, blocks
        per_block = int(intervals.sum())
        self.n_states = per_block * blocks
        starts = np.concatenate([[0], np.cumsum(intervals)[:-1]])
        self.first = (starts[None] + per_block * np.arange(blocks)[:, None]).astype(np.int64)
        self.last = self.first + intervals[None] - 1
        pos = np.concatenate([np.arange(iv) / iv for iv in intervals])
        self.block_id = np.repeat(np.arange(blocks), per_block)
        self.in_beat = np.tile(pos, blocks) < 1.0 / OBSERVATION_LAMBDA
        ratio = intervals[None, :] / intervals[:, None].astype(np.float64)
        prob = np.exp(-TRANSITION_LAMBDA * np.abs(ratio - 1.0))
        prob[prob <= np.spacing(1)] = 0.0
        prob /= prob.sum(axis=1, keepdims=True)
        self.log_t = np.log(np.maximum(prob, EPS)).astype(np.float32)

    def viterbi(self, cols: np.ndarray, ptr: np.ndarray) -> Tuple[np.ndarray, float]:
        """The best state path [T] under the observation log-densities
        `cols` [T, n_cols] (state s reads column ptr[s]), in float32."""
        T = cols.shape[0]
        n_tempi = len(self.intervals)
        score = cols[0][ptr].astype(np.float32)
        backs = np.zeros((T, self.blocks, n_tempi), np.int32)
        for t in range(1, T):
            nxt = np.empty_like(score)
            nxt[0] = np.float32(-1e30)
            nxt[1:] = score[:-1]
            for b in range(self.blocks):
                prev = self.last[(b - 1) % self.blocks]
                cand = score[prev][:, None] + self.log_t                    # [from, to]
                best_from = np.argmax(cand, axis=0)
                nxt[self.first[b]] = cand[best_from, np.arange(n_tempi)]
                backs[t, b] = best_from
            score = nxt + cols[t][ptr]
        s = int(np.argmax(score))
        log_prob = float(score[s])
        first_of = np.full(self.n_states, -1, np.int64)
        first_of[self.first.ravel()] = np.arange(self.first.size)
        path = np.empty(T, np.int64)
        path[T - 1] = s
        for t in range(T - 2, -1, -1):
            f = first_of[s]
            if f >= 0:
                b, to = divmod(int(f), n_tempi)
                s = int(self.last[(b - 1) % self.blocks][backs[t + 1, b, to]])
            else:
                s -= 1
            path[t] = s
        return path, log_prob


def _intervals(min_bpm, max_bpm, fps) -> np.ndarray:
    lo = int(np.round(fps * 60.0 / max_bpm))
    hi = int(np.round(fps * 60.0 / min_bpm))
    return np.arange(max(lo, 2), hi + 1)


def _trim(act, threshold):
    level = act if act.ndim == 1 else act.sum(axis=-1)
    above = np.nonzero(level >= threshold)[0]
    if len(above) == 0:
        return act[:0], 0
    return act[above[0]:above[-1] + 1], int(above[0])


def _segments(mask):
    idx = list(np.nonzero(np.diff(mask.astype(np.int8)))[0] + 1)
    if mask.size and mask[0]:
        idx = [0] + idx
    if mask.size and mask[-1]:
        idx = idx + [mask.size]
    return list(zip(idx[0::2], idx[1::2]))


def beats_from_activations(act: np.ndarray, *, fps, min_bpm, max_bpm, threshold,
                           beats_per_bar: Sequence[int]) -> Dict[str, List[float]]:
    """{beat_pred, downbeat_pred} in seconds: the beat DBN on the beat
    column, the bar DBN (the best of the meters) on [max(beat - downbeat,
    0), downbeat]; each beat moved to the strongest frame of its beat run."""
    intervals = _intervals(min_bpm, max_bpm, fps)
    beat_act, down_act = act[:, 0].astype(np.float64), act[:, 1].astype(np.float64)

    beats: List[float] = []
    a, first = _trim(beat_act, threshold)
    if a.size and a.any():
        sp = _BarPointer(intervals, 1)
        cols = np.stack([np.log(np.maximum((1.0 - a) / (OBSERVATION_LAMBDA - 1), EPS)),
                         np.log(np.maximum(a, EPS))], axis=1).astype(np.float32)
        path, _ = sp.viterbi(cols, sp.in_beat.astype(np.int64))
        beats = [(int(np.argmax(a[l:r])) + l + first) / fps
                 for l, r in _segments(sp.in_beat[path])]

    downbeats: List[float] = []
    combined = np.stack([np.maximum(beat_act - down_act, 0.0), down_act], axis=-1)
    a, first = _trim(combined, threshold)
    if a.shape[0] and a.any():
        cols = np.stack([np.log(np.maximum((1.0 - a.sum(axis=1)) / (OBSERVATION_LAMBDA - 1), EPS)),
                         np.log(np.maximum(a[:, 0], EPS)),
                         np.log(np.maximum(a[:, 1], EPS))], axis=1).astype(np.float32)
        best = None
        for bpb in beats_per_bar:
            sp = _BarPointer(intervals, bpb)
            ptr = np.zeros(sp.n_states, np.int64)
            ptr[sp.in_beat] = 1
            ptr[sp.in_beat & (sp.block_id == 0)] = 2
            path, log_prob = sp.viterbi(cols, ptr)
            if best is None or log_prob > best[0]:
                best = (log_prob, sp, path, ptr)
        _, sp, path, ptr = best
        for l, r in _segments(ptr[path] >= 1):
            peak = int(np.argmax(a[l:r])) // a.shape[1] + l
            if sp.block_id[path[peak]] == 0:
                downbeats.append((peak + first) / fps)
    return {"beat_pred": [float(b) for b in beats], "downbeat_pred": downbeats}
