"""CLI smoke tests (driving through the argparse surface)."""

import json

from kmergma.utils.cli import main


def test_cli_find_genes(tmp_path, capsys, mini_genome, ref_fasta):
    out = tmp_path / "hits.fasta"
    rc = main(
        [
            "find-genes",
            "--genome", mini_genome,
            "--refs", ref_fasta,
            "-o", str(out),
            "--quiet",
        ]
    )
    assert rc == 0
    text = out.read_text()
    assert text.count(">") == 3
    assert "dist = 8.1" in text


def test_cli_exact_match(capsys):
    rc = main(["exact-match", "--query", "GAG", "--subject", "CGAGCCCGAGC"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out) == [[2, 4], [8, 10]]


def test_cli_stdout_output(capsys, mini_genome, ref_fasta):
    rc = main(
        ["find-genes", "--genome", mini_genome, "--refs", ref_fasta, "--quiet", "--no-align"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count(">") == 3
