"""The port's host utilities against the JAX package's (numpy and Pillow on
both sides, so the results are equal, not close): `utils/misc.py`,
`utils/data.py` (image files, one image, the shuffled batch source with its
prefetch thread)."""

import argparse
import pickle
import threading
import time

import numpy as np
import pytest

from clip_glass_tpu.utils import data as jdata
from clip_glass_tpu.utils import misc as jmisc

from clip_glass_torch.utils import AttributeDict, bool_type, range_type, to_list
from clip_glass_torch.utils import data as tdata


@pytest.fixture
def images(tmp_path):
    from PIL import Image

    for i in range(3):
        Image.fromarray((np.random.default_rng(i).uniform(0, 255, (20, 24, 3))
                         ).astype(np.uint8)).save(tmp_path / f"img{i}.png")
    (tmp_path / "sub").mkdir()
    Image.fromarray(np.full((9, 9, 3), 200, np.uint8)).save(tmp_path / "sub" / "x.JPG")
    (tmp_path / "notes.txt").write_text("not an image")
    return tmp_path


def test_find_and_load_images_equal_the_jax_package(images):
    paths = tdata.find_images(str(images))
    assert paths == jdata.find_images(str(images)) and len(paths) == 4
    for p in paths:
        arr = tdata.load_image(p, 16)
        assert arr.shape == (3, 16, 16) and arr.dtype == np.float32
        assert arr.min() >= -1.0 and arr.max() <= 1.0
        assert np.array_equal(arr, jdata.load_image(p, 16))


@pytest.mark.parametrize("prefetch", [False, True])
def test_image_folder_batches_equal_the_jax_package(images, prefetch):
    """The same seed gives the same batches (mirror flips included), from the
    main thread or the prefetch worker."""
    got = tdata.ImageFolder(str(images), resolution=8, batch_size=4, seed=3, prefetch=prefetch)
    want = jdata.ImageFolder(str(images), resolution=8, batch_size=4, seed=3, prefetch=prefetch)
    assert len(got) == len(want) == 4
    it_got, it_want = iter(got), iter(want)
    for _ in range(3):
        a, b = next(it_got), next(it_want)
        assert a.shape == (4, 3, 8, 8) and np.array_equal(a, b)
    it_got.close()
    it_want.close()


def test_image_folder_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdata.ImageFolder(str(tmp_path / "empty"), 16, 2)


def test_image_folder_prefetch_abandoned_iterator_stops(images):
    """Starting a second iterator stops the first one's worker (its stop
    event, within the 0.25 s put timeout): no thread outlives its iterator."""
    ds = tdata.ImageFolder(str(images), resolution=8, batch_size=2, prefetch=True)
    it1 = iter(ds)
    assert next(it1).shape == (2, 3, 8, 8)
    n_before = threading.active_count()
    it2 = iter(ds)
    assert next(it2).shape == (2, 3, 8, 8)
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before
    it2.close()   # its finally sets the stop event
    deadline = time.time() + 5.0
    while threading.active_count() >= n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() < n_before


def test_misc_helpers_match_reference_semantics():
    d = AttributeDict(a=1)
    d.b = {"x": 2}
    assert d.a == 1 and d["b"]["x"] == 2
    with pytest.raises(AttributeError):
        _ = d.missing
    del d.a
    assert "a" not in d
    with pytest.raises(AttributeError):
        del d.a
    rt = pickle.loads(pickle.dumps(d))
    assert rt == d and isinstance(rt, AttributeDict)
    assert repr(AttributeDict(k=3)) == "AttributeDict(k=3)"
    nested = AttributeDict.convert_dict_recursive({"top": {"inner": {"leaf": 3}}, "plain": 4})
    assert nested.top.inner.leaf == 3 and nested.plain == 4

    assert to_list(None) == [] and to_list((1, 2)) == [1, 2]
    assert to_list(5) == [5] and to_list([7]) == [7]
    assert bool_type("Yes") is True and bool_type("0") is False and bool_type(True) is True
    with pytest.raises(argparse.ArgumentTypeError):
        bool_type("maybe")
    assert list(range_type("2-5")) == [2, 3, 4, 5] and range_type("1,4,9") == [1, 4, 9]


@pytest.mark.parametrize("value", [None, (1, 2), 5, [7], "yes", "F", "2-5", "1,4,9"])
def test_misc_helpers_equal_the_jax_package(value):
    for name in ("to_list", "bool_type", "range_type"):
        try:
            want = getattr(jmisc, name)(value)
        except (argparse.ArgumentTypeError, AttributeError, TypeError, ValueError) as e:
            with pytest.raises(type(e)):
                globals()[name](value)
            continue
        got = globals()[name](value)
        assert type(got) is type(want) and list(got if hasattr(got, "__iter__") else [got]) == \
            list(want if hasattr(want, "__iter__") else [want])
