"""Dataset builder: scan -> label (CSV / sidecar / LM-assisted) -> preprocess.

Port of `acestep_tpu/training/dataset_builder.py`: directory scanning with
sidecar conventions, CSV metadata with sniffed delimiters, LM-assisted
annotation (understand-on-codes, or format-lyrics), label persistence, and
preprocess-to-tensors feeding `training.dataset.PreprocessedDataset`.

Sidecar conventions: `<stem>.caption.txt` caption, `<stem>.lyrics.txt` (or
legacy `<stem>.txt`) lyrics, `<stem>.json` metadata; any `*.csv` in the
directory with a `file` column supplies bpm / key / caption. Later sources
win: the sidecar text files, then the JSON, then the CSV row. Fields that
came from them win over the planner's labels.

`lock` (the port's addition): a lock held around each sample's work on the
handlers (its codes and label, its tensors), so that a server's jobs run
between samples rather than after the whole dataset.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from acestep_tpu_torch.training.dataset import preprocess_audio_to_sample, save_sample, write_manifest
from acestep_tpu_torch.utils import audio as audio_utils

SUPPORTED_AUDIO_FORMATS = (".wav", ".mp3", ".flac", ".ogg", ".opus")
SAMPLE_RATE = 48_000


@dataclasses.dataclass
class AudioSample:
    audio_path: str
    filename: str
    caption: str = ""
    lyrics: str = "[Instrumental]"
    raw_lyrics: str = ""
    bpm: Optional[int] = None
    keyscale: str = ""
    timesignature: str = ""
    language: str = "unknown"
    genre: str = ""
    duration: Optional[float] = None
    labeled: bool = False
    label_source: str = ""  # "sidecar" | "csv" | "lm" | "lm_format" | "manual"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _csv_row_meta(row: Dict[str, str], header: Dict[str, str]) -> Dict[str, Any]:
    meta: Dict[str, Any] = {}
    if "bpm" in header and (row.get(header["bpm"]) or "").strip():
        try:
            meta["bpm"] = int(float(row[header["bpm"]]))
        except ValueError:
            pass
    for col, key in (("key", "keyscale"), ("keyscale", "keyscale"), ("caption", "caption"),
                     ("language", "language"), ("timesignature", "timesignature")):
        if col in header and (row.get(header[col]) or "").strip():
            meta[key] = row[header[col]].strip()
    return meta


def load_csv_metadata(directory: str) -> Dict[str, Dict[str, Any]]:
    """Any *.csv with a `file` column -> {filename: {bpm, keyscale, caption,
    ...}}: the delimiter sniffed among `,`, `;` and tab, headers matched
    case-insensitively."""
    out: Dict[str, Dict[str, Any]] = {}
    for f in sorted(os.listdir(directory)):
        if not f.lower().endswith(".csv"):
            continue
        try:
            with open(os.path.join(directory, f), encoding="utf-8") as fh:
                sample = fh.read(4096)
                fh.seek(0)
                try:
                    reader = csv.DictReader(fh, dialect=csv.Sniffer().sniff(sample, delimiters=",;\t"))
                except csv.Error:
                    reader = csv.DictReader(fh)
                if not reader.fieldnames:
                    continue
                header = {h.lower().strip(): h for h in reader.fieldnames}
                if "file" not in header:
                    continue
                for row in reader:
                    name = (row.get(header["file"]) or "").strip()
                    meta = _csv_row_meta(row, header) if name else None
                    if meta:
                        out[name] = meta
        except OSError:
            continue
    return out


def _read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read().strip()


class DatasetBuilder:
    """scan_directory -> label_all (LM-assisted) -> preprocess_to_tensors."""

    def __init__(self, dit_handler, llm_handler=None, lock=None):
        self.dit = dit_handler
        self.llm = llm_handler
        self.lock = lock if lock is not None else contextlib.nullcontext()
        self.samples: List[AudioSample] = []
        self.directory: Optional[str] = None

    # -------------------------------------------------------------- scan
    def scan_directory(self, directory: str) -> Tuple[List[AudioSample], str]:
        if not os.path.isdir(directory):
            return [], f"not a directory: {directory}"
        self.directory = directory
        self.samples = []
        csv_meta = load_csv_metadata(directory)
        files = sorted(
            os.path.join(root, n)
            for root, _dirs, names in os.walk(directory)
            for n in names
            if os.path.splitext(n)[1].lower() in SUPPORTED_AUDIO_FORMATS
        )
        n_caption = n_lyrics = n_csv = 0
        for path in files:
            base = os.path.splitext(path)[0]
            s = AudioSample(audio_path=path, filename=os.path.basename(path))
            if os.path.exists(base + ".caption.txt"):
                s.caption = _read_text(base + ".caption.txt")
                s.label_source = "sidecar"
                n_caption += 1
            for suffix in (".lyrics.txt", ".txt"):
                if os.path.exists(base + suffix):
                    s.raw_lyrics = _read_text(base + suffix)
                    s.lyrics = s.raw_lyrics or s.lyrics
                    n_lyrics += 1
                    break
            if os.path.exists(base + ".json"):
                try:
                    with open(base + ".json", encoding="utf-8") as f:
                        meta = json.load(f)
                    for k in ("caption", "lyrics", "keyscale", "timesignature", "language"):
                        if meta.get(k):
                            setattr(s, k, str(meta[k]))
                    if meta.get("bpm") is not None:
                        s.bpm = int(meta["bpm"])
                except (OSError, ValueError):
                    pass
            cm = csv_meta.get(s.filename)
            if cm:
                for k, v in cm.items():
                    setattr(s, k, v)
                n_csv += 1
            s.labeled = bool(s.caption)
            self.samples.append(s)
        msg = f"{len(self.samples)} audio files ({n_caption} captions, {n_lyrics} lyrics, {n_csv} csv rows)"
        return self.samples, msg

    # -------------------------------------------------------------- label
    def label_sample(self, idx: int, *, format_lyrics: bool = False,
                     temperature: float = 0.7, seed: int = 0) -> Tuple[Optional[AudioSample], str]:
        """LM-assisted annotation of one sample: encode the audio to 5 Hz
        codes, then the planner's `understand` (or `format_sample` when
        preloaded lyrics should be normalized). Fields that came from the CSV
        or a sidecar win over the planner's. A failure stays this sample's:
        it comes back in the message."""
        if not (0 <= idx < len(self.samples)):
            return None, f"invalid sample index {idx}"
        s = self.samples[idx]
        if self.llm is None:
            return s, "no LLM handler — sidecar/CSV labels only"

        had_bpm, had_key, had_caption = s.bpm is not None, bool(s.keyscale), bool(s.caption)
        try:
            audio = audio_utils.load_audio(s.audio_path)
            s.duration = audio.shape[1] / SAMPLE_RATE
            with self.lock:
                codes_str = self.dit.convert_audio_to_codes(audio)
                if format_lyrics and s.raw_lyrics:
                    out = self.llm.format_sample_from_input(s.raw_lyrics, temperature=temperature, seed=seed)
                    s.label_source = "lm_format"
                else:
                    out = self.llm.understand_audio_from_codes(codes_str, temperature=temperature, seed=seed)
                    s.label_source = "lm"
            md = out.get("metadata", {})
            if not had_caption and md.get("caption"):
                s.caption = str(md["caption"])
            if not had_bpm and md.get("bpm") is not None:
                try:
                    s.bpm = int(md["bpm"])
                except (TypeError, ValueError):
                    pass
            if not had_key and md.get("keyscale"):
                s.keyscale = str(md["keyscale"])
            if md.get("timesignature"):
                s.timesignature = str(md["timesignature"])
            if md.get("language"):
                s.language = str(md["language"])
            if md.get("genres"):
                s.genre = str(md["genres"])
            if md.get("lyrics") and not s.raw_lyrics:
                s.lyrics = str(md["lyrics"])
            s.labeled = True
            return s, f"labeled {s.filename} via {s.label_source}"
        except Exception as e:  # noqa: BLE001 — per-sample failure isolation
            return s, f"label failed for {s.filename}: {e}"

    def label_all(self, **kw) -> List[str]:
        return [self.label_sample(i, **kw)[1] for i in range(len(self.samples))]

    # ------------------------------------------------------------ persist
    def save_labels(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.directory or ".", "labels.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump([s.to_dict() for s in self.samples], f, ensure_ascii=False, indent=1)
        return path

    def load_labels(self, path: Optional[str] = None) -> int:
        path = path or os.path.join(self.directory or ".", "labels.json")
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        self.samples = [AudioSample(**d) for d in data]
        return len(self.samples)

    # --------------------------------------------------------- preprocess
    def preprocess_to_tensors(self, output_dir: str, max_duration: float = 240.0,
                              progress_cb=None) -> Tuple[List[str], str]:
        """Each sample -> an .npz of training tensors (`preprocess_audio_to_sample`,
        the audio cut to `max_duration`) and one manifest.json.
        `progress_cb(idx, sample, status)` fires after each sample; a failed
        sample is counted in the message and skipped."""
        os.makedirs(output_dir, exist_ok=True)
        entries, written = [], []
        errors: Dict[str, str] = {}
        for i, s in enumerate(self.samples):
            try:
                audio = audio_utils.load_audio(s.audio_path)[:, : int(max_duration * SAMPLE_RATE)]
                # A string, as the JAX package passes it to parse_metas.
                metas = (
                    f"- bpm: {s.bpm or 'N/A'}\n"
                    f"- timesignature: {s.timesignature or 'N/A'}\n"
                    f"- keyscale: {s.keyscale or 'N/A'}\n"
                    f"- duration: {int(audio.shape[1] / SAMPLE_RATE)} seconds\n"
                )
                with self.lock:
                    sample = preprocess_audio_to_sample(self.dit, audio, s.caption, s.lyrics, metas=metas,
                                                        vocal_language=s.language)
                out_name = os.path.splitext(s.filename)[0] + ".npz"
                save_sample(os.path.join(output_dir, out_name), sample)
                entries.append({"file": out_name, "source": s.filename, "caption": s.caption, "bpm": s.bpm,
                                "keyscale": s.keyscale, "language": s.language})
                written.append(out_name)
                if progress_cb is not None:
                    progress_cb(i, s, "ok")
            except Exception as e:  # noqa: BLE001 — per-sample failure isolation
                errors[s.filename] = str(e)
                if progress_cb is not None:
                    progress_cb(i, s, f"error: {e}")
        write_manifest(output_dir, entries)
        msg = f"wrote {len(written)}/{len(self.samples)} samples to {output_dir}"
        if errors:
            msg += f" ({len(errors)} failed: {sorted(errors)[:3]}...)"
        return written, msg
