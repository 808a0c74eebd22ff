"""The PyTorch port's SLURM launchers (``hpc/torch/*.slurm``): each is valid
bash, keeps the timestamped log of ``hpc/train.slurm``, and starts only
subcommands that the port's command line has."""

import argparse
import glob
import os
import re
import subprocess

import pytest

from maunet_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(REPO, "hpc", "torch", "*.slurm")))


def _subcommands() -> set[str]:
    parser = cli.build_parser()
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return set(sub.choices)


def test_every_launcher_but_earth_engine_and_the_tpu_vm():
    names = {os.path.basename(p)[:-len(".slurm")] for p in SCRIPTS}
    assert names == {"train", "evaluate", "sensitivity", "gt_sensitivity",
                     "compare_sensitivity", "stats", "eda", "pack", "dataset"}


@pytest.mark.parametrize("path", SCRIPTS, ids=os.path.basename)
def test_launcher_parses_logs_and_starts_port_subcommands(path):
    subprocess.run(["bash", "-n", path], check=True)
    text = open(path).read()
    assert 'exec > "$LOGFILE" 2>&1' in text and "TIMESTAMP=$(date" in text
    started = re.findall(r"-m maunet_tpu_torch\.cli ([a-z-]+)", text)
    assert started and set(started) <= _subcommands(), started
    assert "maunet_tpu.cli" not in text
    if path.endswith("train.slurm"):
        assert re.search(r'torchrun .*--nproc-per-node "\$\{SLURM_GPUS_ON_NODE:-1\}" '
                         r'-m maunet_tpu_torch\.cli train "\$@"', text)
