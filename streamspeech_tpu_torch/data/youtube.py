"""YouTube sources of a streaming evaluation (``streamspeech_tpu/data/
youtube.py:29-109``; reference `SimulEval/simuleval/data/dataloader/
s2t_dataloader.py:25-56,114-140`): a YouTube URL resolves to a cached
``<video_id>.wav``, mono 16 kHz. The downloader is injected; the default one
needs the ``yt_dlp`` package, which neither this repository's machines nor its
tests have, and it raises without it. URL parsing, the cache and the mono
16 kHz conversion are the standard library and numpy."""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

YOUTUBE_HOSTS = ("youtube.com", "www.youtube.com", "m.youtube.com",
                 "youtu.be", "www.youtu.be")


def is_youtube_url(ref: str) -> bool:
    if not ref.startswith(("http://", "https://")):
        return False
    return urlparse(ref).netloc.lower() in YOUTUBE_HOSTS


def get_video_id(url: str) -> str:
    """The ``?v=`` query parameter (`s2t_dataloader.py:26-32`), or the id of a
    ``youtu.be/<id>`` short link."""
    u = urlparse(url)
    video = parse_qs(u.query).get("v", [])
    if video:
        return video[0]
    if u.netloc.lower().endswith("youtu.be") and len(u.path) > 1:
        return u.path.lstrip("/").split("/")[0]
    raise ValueError(f"unrecognized youtube url format: {url}")


def to_mono_16k(path: str, out_path: Optional[str] = None) -> str:
    """A 16-bit wav → mono 16 kHz (the channels' mean, linear resampling),
    written to ``out_path`` (default: in place)."""
    with wave.open(str(path), "rb") as f:
        ch, sw, sr, n = f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes()
        raw = f.readframes(n)
    if sw != 2:
        raise ValueError(f"unsupported sample width {sw} in {path}")
    mono = np.frombuffer(raw, dtype="<i2").reshape(-1, ch).astype(np.float32).mean(axis=1)
    if sr != 16000:
        t_out = np.arange(int(round(len(mono) * 16000 / sr)), dtype=np.float64) * (sr / 16000.0)
        mono = np.interp(t_out, np.arange(len(mono), dtype=np.float64), mono)
    out = Path(out_path) if out_path else Path(path)
    with wave.open(str(out), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(np.clip(mono, -32768, 32767).astype("<i2").tobytes())
    return str(out)


def _default_downloader(url: str, out_base: str) -> str:
    """bestaudio → wav through ``yt_dlp`` (`s2t_dataloader.py:38-50`); raises
    ImportError where ``yt_dlp`` is absent."""
    import yt_dlp

    opts = {"format": "bestaudio/best",
            "postprocessors": [{"key": "FFmpegExtractAudio", "preferredcodec": "wav",
                                "preferredquality": "192"}],
            "outtmpl": out_base}
    with yt_dlp.YoutubeDL(opts) as ydl:
        ydl.download([url])
    return out_base + ".wav"


def resolve_youtube_source(url: str, cache_dir: str = ".",
                           downloader: Optional[Callable[[str, str], str]] = None) -> str:
    """URL → the local mono 16 kHz ``<cache_dir>/<video_id>.wav``, fetched by
    ``downloader(url, out_base)`` only where it is not cached yet."""
    vid = get_video_id(url)
    cache = Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    wav = cache / f"{vid}.wav"
    if wav.exists():
        return str(wav)
    try:
        got = (downloader or _default_downloader)(url, str(cache / vid))
    except ImportError as e:
        raise RuntimeError("a youtube source needs yt_dlp, which is not installed; "
                           f"put the audio at {wav} instead") from e
    return to_mono_16k(got, str(wav))
