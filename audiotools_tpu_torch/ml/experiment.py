"""Experiment tracking utilities: run directories with generated names and
git snapshots for code provenance. Counterpart of
``audiotools_tpu/ml/experiment.py``."""
import datetime
import os
import random
import shlex
import shutil
import subprocess
import typing
from pathlib import Path

# Word lists for generated run names (no `randomname` dependency).
_ADJECTIVES = [
    "amber", "brisk", "calm", "deft", "eager", "fuzzy", "gilded", "hazy",
    "icy", "jolly", "keen", "lucid", "mellow", "nimble", "opal", "plucky",
    "quiet", "rapid", "sleek", "tidal", "umber", "vivid", "wry", "zesty",
]
_NOUNS = [
    "aurora", "breeze", "cinder", "delta", "ember", "fjord", "glade",
    "harbor", "inlet", "juniper", "krill", "lagoon", "mesa", "nebula",
    "osprey", "prairie", "quartz", "reef", "summit", "tundra", "umbra",
    "vortex", "willow", "zephyr",
]


class Experiment:
    """Context manager that chdirs into a run directory and can snapshot
    all git-tracked files for exact code provenance.

    Parameters
    ----------
    exp_directory : str
        Root folder collecting every run directory, by default "runs/".
    exp_name : str, optional
        Experiment name; defaults to ``<date>-<adjective>-<noun>``.
    """

    def __init__(
        self,
        exp_directory: str = "runs/",
        exp_name: str = None,
    ):
        self.exp_name = exp_name or self.generate_exp_name()
        self.exp_dir = Path(exp_directory) / self.exp_name
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.parent_directory = Path.cwd().absolute()
        self.git_tracked_files = self._list_git_files()

    @staticmethod
    def _list_git_files():
        cmd = shlex.split("git ls-tree --full-tree --name-only -r HEAD")
        try:
            listing = subprocess.check_output(cmd, stderr=subprocess.DEVNULL)
        except subprocess.CalledProcessError:
            return []
        return listing.decode("utf-8").splitlines()

    def __enter__(self):
        self.prev_dir = Path.cwd()
        os.chdir(self.exp_dir)
        return self

    def __exit__(self, *exc_info):
        os.chdir(self.prev_dir)

    @staticmethod
    def generate_exp_name():
        """Random experiment name from the date plus an adjective-noun
        pair."""
        stamp = datetime.datetime.now().strftime("%y%m%d")
        return "-".join(
            [stamp, random.choice(_ADJECTIVES), random.choice(_NOUNS)]
        )

    def snapshot(self, filter_fn: typing.Callable = lambda f: True):
        """Copy all git-tracked files into the run directory."""
        for tracked in filter(filter_fn, self.git_tracked_files):
            destination = Path(tracked)
            destination.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(self.parent_directory / tracked, destination)
