"""Dataset preprocessing: CSV manifests of audio files.

Counterpart of ``audiotools_tpu/data/preprocess.py``; the loudness column
is metered on the host with this package's BS.1770 meter.
"""
import csv
import os
from pathlib import Path

import torch

from ..core.loudness import Meter
from ..io import load_audio


def create_csv(audio_files: list, output_csv: Path, loudness: bool = False,
               data_path: str = None):
    """Write a CSV of ``audio_files`` (column ``path``) and, with
    ``loudness``, each file's integrated loudness in LUFS.

    Paths are written relative to ``data_path`` (or the ``PATH_TO_DATA``
    environment variable) where they lie under it, so a manifest moves with
    its data. An empty name writes an empty row (loudness ``-inf``), which
    keeps the rows of multitrack manifests aligned.
    """
    data_path = Path(os.getenv("PATH_TO_DATA", "") if data_path is None else data_path)
    fieldnames = ["path"] + (["loudness"] if loudness else [])
    with open(output_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        for af in map(Path, audio_files):
            row = {}
            if af.name == "":
                row["path"] = ""
                if loudness:
                    row["loudness"] = -float("inf")
                writer.writerow(row)
                continue
            if loudness:
                data, rate = load_audio(af)
                row["loudness"] = float(Meter(rate)(torch.from_numpy(data.T.copy())[None]))
            try:
                row["path"] = str(af.relative_to(data_path))
            except ValueError:
                row["path"] = str(af)
            writer.writerow(row)
    return output_csv
