"""Write an enhancement, dereverberation or bandwidth-extension corpus
(counterpart of preprocessing/create_data.py).

    python -m storm_tpu_torch.preprocessing.create_data --task derev+enh --root DIR \\
        [--speech wsj0|vctk|timit|dir] [--speech_dir D] [--noise chime|wham|none] \\
        [--noise_dir N] [--splits cv,tr,tt] [--bwe-method polyphase|decimate] [--dummy]

Tasks enh, derev, derev+enh and bwe, with the reference's distributions:
SNR in [-6, 14] dB, T60 in [0.4, 1.0] s in a room of 5-15 x 5-15 x 2-6 m,
down-sampling by 2, 4 or 8 through a bessel, butter or cheby2 low-pass of
order 2, 4 or 8. Output: `<root>/<speech>_<task>[_<noise>]/audio/<split>/
{clean,noisy}/<name>_<i>[_t60=..][_snr=..][_down=..].wav`, 16-bit PCM, and
`log_stats.txt` with the parameters. All draws come from one
`np.random.default_rng(100)` in the JAX script's order, so one tree of
inputs gives the same bytes with either package. `--speech dns` raises
ValueError and `--noise qut` NotImplementedError, as in the reference.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
from os.path import join
from typing import Optional, Sequence

import numpy as np
import scipy.signal as ss

from ..data.audio import load_wav, save_wav
from .room import measure_rt60, simulate_dry, simulate_shoebox
from .utils import obtain_noise_file

SEED = 100

bwe_params = {
    "scale_factors": [2, 4, 8],
    "scale_probas": [0.33, 0.33, 0.34],
    "lp_types": ["bessel", "butter", "cheby2"],
    "lp_orders": [2, 4, 8],
}
enh_params = {"snr_range": [-6, 14]}
derev_params = {
    "t60_range": [0.4, 1.0],
    "dim_range": [5, 15, 5, 15, 2, 6],
    "min_distance_to_wall": 1.0,
}


def speech_file_lists(args, splits):
    """({split: clean speech files}, {split: transcriptions}) of the
    corpus layout `args.speech`; `dir` reads <speech_dir>/<split>/*.wav."""
    ROOT = args.root
    lists, transcriptions = {}, {}
    if args.speech == "wsj0":
        dic = {"cv": "si_dt_05", "tr": "si_tr_s", "tt": "si_et_05"}
        for split in splits:
            lists[split] = sorted(glob.glob(f"{ROOT}/WSJ0/wsj0/{dic[split]}/**/*.wav"))
    elif args.speech == "vctk":
        speakers = sorted(os.listdir(f"{ROOT}/VCTK-Corpus/wav48/"))
        for bad in ("p280", "p315"):
            if bad in speakers:
                speakers.remove(bad)
        ranges = {"tr": [0, 99], "cv": [97, 99], "tt": [99, 107]}
        for split in splits:
            lists[split] = []
            for spk_idx in range(*ranges[split]):
                lists[split] += glob.glob(f"{ROOT}/VCTK-Corpus/wav48/{speakers[spk_idx]}/*.wav")
    elif args.speech == "timit":
        ranges = {"tr": [1, 7], "cv": [7, 8], "tt": [1, 8]}
        for split in splits:
            lists[split], transcriptions[split] = [], []
            sdr = "train" if split in ("cv", "tr") else "test"
            for dr in range(*ranges[split]):
                lists[split] += sorted(glob.glob(f"{ROOT}/TIMIT/timit/{sdr}/dr{dr}/**/*.wav"))
                transcriptions[split] += sorted(
                    glob.glob(f"{ROOT}/TIMIT/timit/{sdr}/dr{dr}/**/*.txt"))
    elif args.speech == "dir":
        for split in splits:
            lists[split] = sorted(glob.glob(join(args.speech_dir, split, "*.wav")))
    else:
        raise ValueError(args.speech)
    return lists, transcriptions


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--task", type=str, required=True,
                        choices=["enh", "derev", "derev+enh", "bwe"])
    parser.add_argument("--speech", type=str, default="wsj0",
                        choices=["vctk", "wsj0", "dns", "timit", "dir"])
    parser.add_argument("--noise", type=str, default="chime",
                        choices=["none", "chime", "qut", "wham"])
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--splits", type=str, default="cv,tr,tt")
    parser.add_argument("--corruption-per-sample", type=int, default=1)
    parser.add_argument("--dummy", action="store_true")
    parser.add_argument("--bwe-method", type=str, default="polyphase",
                        choices=["decimate", "polyphase"])
    parser.add_argument("--root", type=str, required=True,
                        help="root databases directory (output goes here)")
    parser.add_argument("--speech_dir", type=str, default=None,
                        help="speech dir for --speech dir layout")
    parser.add_argument("--noise_dir", type=str, default=None,
                        help="noise dir (template with {split} allowed)")
    return parser.parse_args(argv)


def bwe(lossy: np.ndarray, rng: np.random.Generator, params: dict, method: str, sr: int):
    """(band-limited signal, scale factor): a random low-pass, down-sampled
    by the factor and brought back to `sr`."""
    scale_factor = int(rng.choice(params["scale_factors"], p=params["scale_probas"]))
    lp_type = str(rng.choice(params["lp_types"]))
    lp_order = int(rng.choice(params["lp_orders"]))
    Wn = 1.0 / (2 * scale_factor)
    kwargs = {}
    if lp_type == "cheby2":
        kwargs["rs"] = 10.0 + 20 * rng.random()
    if lp_order > 2:
        kwargs["output"] = "sos"
    coefs = getattr(ss, lp_type)(N=lp_order, Wn=Wn, fs=1, **kwargs)
    if method == "decimate":
        z, p, k = ss.sos2zpk(coefs) if lp_order > 2 else ss.tf2zpk(*coefs)
        sub = ss.decimate(lossy, q=scale_factor, ftype=ss.dlti(z, p, k))
        return ss.resample_poly(sub, up=scale_factor, down=1), scale_factor
    sos = coefs if lp_order > 2 else ss.tf2sos(*coefs)
    sub = ss.resample_poly(ss.sosfilt(sos, lossy), down=scale_factor, up=1)
    return ss.resample_poly(sub, up=sr, down=sr // scale_factor), scale_factor


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    rng = np.random.default_rng(SEED)
    splits = args.splits.strip().split(",")
    params = vars(args).copy()
    if "enh" in args.task:
        params.update(enh_params)
    if "derev" in args.task:
        params.update(derev_params)
    if "bwe" in args.task:
        params.update(bwe_params)

    output_dir = join(args.root, args.speech + "_" + args.task)
    if args.task == "enh":
        output_dir += "_" + args.noise
    if os.path.exists(output_dir):
        shutil.rmtree(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    with open(join(output_dir, "log_stats.txt"), "w") as log:
        log.write("Parameters \n ========== \n")
        for key, param in params.items():
            log.write(f"{key} : {param}\n")

    speech_lists, transcription_lists = speech_file_lists(args, splits)

    for i_split, split in enumerate(splits):
        print(f"Processing split n° {i_split + 1}: {split}...")
        clean_dir = join(output_dir, "audio", split, "clean")
        noisy_dir = join(output_dir, "audio", split, "noisy")
        os.makedirs(clean_dir, exist_ok=True)
        os.makedirs(noisy_dir, exist_ok=True)
        if args.speech == "timit":
            trans_dir = join(output_dir, "transcriptions", split)
            os.makedirs(trans_dir, exist_ok=True)

        speech_list = speech_lists[split]
        n_samples = min(5, len(speech_list)) if args.dummy else len(speech_list)
        n_corr = 1 if split == "tt" else args.corruption_per_sample

        for i_sample in range(n_samples):
            basename = os.path.basename(speech_list[i_sample])
            speech_orig, sr = load_wav(speech_list[i_sample])
            if sr != args.sr:
                raise ValueError(f"{speech_list[i_sample]}: sampling rate {sr}, expected {args.sr}")
            speech_orig = speech_orig[0]

            for ic in range(n_corr):
                speech = speech_orig.copy()
                lossy = speech.copy()
                t60_real = snr = scale_factor = None

                if "derev" in args.task:
                    t60 = rng.uniform(*params["t60_range"])
                    dim = np.array([rng.uniform(params["dim_range"][2 * n],
                                                params["dim_range"][2 * n + 1])
                                    for n in range(3)])
                    mdw = params["min_distance_to_wall"]
                    mic = np.array([rng.uniform(mdw, dim[n] - mdw) for n in range(3)])
                    src = np.array([rng.uniform(mdw, dim[n] - mdw) for n in range(3)])
                    lossy, rir = simulate_shoebox(lossy, dim, src, mic, t60, fs=args.sr, rng=rng)
                    t60_real = measure_rt60(rir, fs=args.sr)
                    # the dry room's direct path as the target, a 50 dB noise floor after it
                    speech, _ = simulate_dry(speech, dim, src, mic, fs=args.sr)
                    nf_power = np.sum(speech**2) / len(speech) * 10 ** (-50 / 10)
                    floor = rng.random(int(0.5 * args.sr)) * np.sqrt(nf_power)
                    speech = np.concatenate([speech, floor])
                    m = min(len(lossy), len(speech))
                    lossy, speech = lossy[:m], speech[:m]

                if "enh" in args.task:
                    noise_dir = (args.noise_dir or "").format(split=split)
                    noise, _ = obtain_noise_file(
                        noise_dir, i_sample, 1, dataset=args.noise,
                        sample_rate=args.sr, len_speech=len(speech), rng=rng)
                    noise = np.squeeze(noise)
                    if len(noise) < len(speech):
                        noise = np.pad(noise, (0, len(speech) - len(noise)))
                    else:
                        noise = noise[: len(speech)]
                    snr = rng.uniform(*params["snr_range"])
                    npow = np.sum(noise**2) / len(noise)
                    spow = np.sum(speech**2) / len(speech)
                    scale = np.sqrt(spow * 10 ** (-snr / 10) / max(npow, 1e-30))
                    base = lossy if "derev" in args.task else speech
                    lossy = base[: len(noise)] + scale * noise[: len(base)]

                if "bwe" in args.task:
                    lossy, scale_factor = bwe(lossy, rng, params, args.bwe_method, args.sr)

                filename = basename[:-4] + f"_{i_sample * args.corruption_per_sample + ic}"
                if t60_real is not None:
                    filename += f"_t60={t60_real:.2f}"
                if snr is not None:
                    filename += f"_snr={snr:.1f}"
                if scale_factor is not None:
                    filename += f"_down={scale_factor}"
                filename += ".wav"

                m = min(len(speech), len(lossy))
                save_wav(join(clean_dir, filename), speech[:m], args.sr)
                save_wav(join(noisy_dir, filename), lossy[:m], args.sr)
                if args.speech == "timit":
                    shutil.copy(transcription_lists[split][i_sample],
                                join(trans_dir, filename[:-4] + ".txt"))
    print("done.")


if __name__ == "__main__":
    main()
