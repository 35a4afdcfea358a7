"""The digest census (``paxos_tpu_torch/scripts/digest_census.py``) at a
tiny size (no GPU, no JAX): the coverage digest folds 296 words a tick at
config3's 8-slot window and 432 at config3-long's 16, the counts K5's
observed tick folds, and a prefix cache would refold a share of them in
(0, 1] on a tick that changed a word."""

import pytest

from paxos_tpu_torch.scripts import digest_census


@pytest.mark.parametrize("config,words", [("config3", 296), ("config3long", 432)])
def test_digest_census_counts_the_folded_words(config, words):
    out = digest_census.refold_share(config, lanes=64, seed=0, start=4, stop=12)
    assert out["words"] == words
    assert 0.0 < out["refold_share"] <= 1.0
    assert 0.0 <= out["unchanged_share"] < 1.0
    assert digest_census.main(["--config", config, "--lanes", "16", "--start", "0", "--stop", "2"]) == 0
