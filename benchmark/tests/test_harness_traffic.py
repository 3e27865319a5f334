"""The traffic generator repeats by seed, and a mix keeps its shapes."""

import pytest

from harness import spec, traffic
from reference.model import LYRIC_BUCKETS, TEXT_BUCKETS, prompt_texts, tokenize

CELLS = [w["name"] for w in spec.bench_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_requests_repeat_by_seed(name):
    cell = spec.load_cell(name)
    material = traffic.prompts(cell.traffic)
    seed = 2**31 + 12345
    a = [traffic.request(cell.traffic, material, seed, i) for i in range(-1, 20)]
    b = [traffic.request(cell.traffic, material, seed, i) for i in range(-1, 20)]
    assert a == b
    other = [traffic.request(cell.traffic, material, seed + 1, i) for i in range(-1, 20)]
    assert a != other


@pytest.mark.parametrize("name", CELLS)
def test_every_request_of_a_mix_has_the_same_shapes(name):
    cell = spec.load_cell(name)
    material = traffic.prompts(cell.traffic)
    shapes = set()
    for seed in (1, 2**33 + 7):
        for i in range(-1, 40):
            req = traffic.request(cell.traffic, material, seed, i)
            assert len(req["seeds"]) == cell.traffic["batch"]
            text, lyric = prompt_texts(req["captions"][0], req["lyrics"][0], req["language"], req["duration_s"])
            shapes.add((tokenize([text], 256, TEXT_BUCKETS)[0].shape, tokenize([lyric], 2048, LYRIC_BUCKETS)[0].shape,
                        req["duration_s"], len(req["seeds"])))
    assert len(shapes) == 1
