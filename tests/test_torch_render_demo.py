"""The port's render demo (``scripts/torch_render_demo.py``) against the JAX
package's (``scripts/render_demo.py``) at 48^2 on a 32^3 turbulence (seed
7): the five images through the plain renders on the CPU equal, in uint8,
the same five renders through the JAX functions the JAX script calls
(``render_compositing``, ``render_isosurface`` at 90/255, ``kdtree.build`` at
tolerance 2 with ``CompressedRenderer.render`` at ``orig_depth - 6``,
``query_error`` of the leaf cut).  The full cut's JAX image renders the host
``level_cut`` of the tree, which JAX's tests hold equal to its device decode
(``test_io_device_decode.py``): ``CompressedRenderer.render`` at the full
cut would compile JAX's decode at depth 22, ~18 s of this file's time.  The
PNG writer and reader round-trip, and PIL decodes the files to the same
arrays."""
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from volumerenderer_tpu import Camera as JCamera
from volumerenderer_tpu import as_normalized_volume as j_normalized
from volumerenderer_tpu import generate_rays as j_rays
from volumerenderer_tpu.codecs import kdtree as JK
from volumerenderer_tpu.io.synthetic import turbulence_volume as j_turbulence
from volumerenderer_tpu.models.compressed import CompressedRenderer as JCompressed
from volumerenderer_tpu.ops.isosurface import render_isosurface as j_iso
from volumerenderer_tpu.ops.raycast import render_compositing as j_render

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import torch_render_demo as demo  # noqa: E402

SIZE, DIMS = 48, (32, 32, 32)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("demo")
    images, build_s = demo.main(out_dir=str(out), size=SIZE, dims=DIMS, device="cpu")
    return out, images, build_s


@pytest.fixture(scope="module")
def jax_images():
    """The JAX script's five renders, without its PIL writer (the full cut
    from the host decode, see the module docstring)."""
    vol_u8 = j_turbulence(DIMS, seed=7)
    vol = j_normalized(vol_u8)
    rays = j_rays(JCamera(width=SIZE, height=SIZE))
    args = (rays.entry_uv, rays.direction, rays.hit)
    tree = JK.build(vol_u8, tolerance=2, max_epochs=2)
    r = JCompressed(tree)
    full = JK.level_cut(tree)
    err = JK.query_error(full, vol_u8)
    return {"compositing": j_render(vol, *args)[0],
            "isosurface": j_iso(vol, *args, iso_value=90 / 255.0)[0],
            "compressed_full": j_render(j_normalized(full), *args)[0],
            "compressed_coarse": r.render(rays, cut_depth=tree.orig_depth - 6)[0],
            "error_field": j_render(j_normalized(err), *args)[0]}


def test_writes_the_five_files(port_run):
    out, images, build_s = port_run
    assert sorted(p.name for p in out.iterdir()) == sorted(f"{n}.png" for n in demo.IMAGES)
    assert list(images) == list(demo.IMAGES) and build_s > 0


@pytest.mark.parametrize("name", demo.IMAGES)
def test_image_equals_jax(port_run, jax_images, name):
    _, images, _ = port_run
    got, want = demo.to_uint8(images[name]), demo.to_uint8(np.asarray(jax_images[name]))
    assert got.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", demo.IMAGES)
def test_png_reads_back_as_its_array(port_run, name):
    out, images, _ = port_run
    np.testing.assert_array_equal(demo.read_png(str(out / f"{name}.png")),
                                  demo.to_uint8(images[name]))


def test_the_images_differ():
    """Not five copies of one frame: the modes and cuts render differently."""
    vol_u8, vol, rays = demo.demo_inputs(SIZE, DIMS, "cpu")
    tree, _ = demo.build_tree(vol_u8)
    imgs = {n: demo.to_uint8(f()) for n, f in demo.renders(vol_u8, vol, rays, tree).items()}
    names = list(imgs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not np.array_equal(imgs[a], imgs[b]), (a, b)


def test_kernel_entry_points_on_cpu_tensors_equal_plain():
    """The kernels' branch of ``renders`` on CPU tensors (each wrapper's
    plain version) gives the plain renders' images bit for bit."""
    vol_u8, vol, rays = demo.demo_inputs(SIZE, DIMS, "cpu")
    tree, _ = demo.build_tree(vol_u8)
    kernel = demo.renders(vol_u8, vol, rays, tree)
    plain = demo.renders(vol_u8, vol, rays, tree, plain=True)
    for name in demo.IMAGES:
        assert torch.equal(kernel[name](), plain[name]()), name


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (64, 3)])
def test_png_round_trip(tmp_path, hw):
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    demo.write_png(path, img)
    np.testing.assert_array_equal(demo.read_png(path), img)


def test_png_reader_takes_split_idat_and_checks_crc(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    rows = np.concatenate([np.zeros((9, 1), np.uint8), img.reshape(9, 33)], axis=1)
    packed = zlib.compress(rows.tobytes())
    path = tmp_path / "split.png"
    path.write_bytes(demo.PNG_SIGNATURE
                     + demo._chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 8, 2, 0, 0, 0))
                     + demo._chunk(b"IDAT", packed[:10]) + demo._chunk(b"tEXt", b"k\0v")
                     + demo._chunk(b"IDAT", packed[10:]) + demo._chunk(b"IEND", b""))
    np.testing.assert_array_equal(demo.read_png(str(path)), img)
    data = bytearray(path.read_bytes())
    data[43] ^= 1  # inside the first IDAT's data (it starts at byte 41)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC32"):
        demo.read_png(str(path))


def test_png_writer_refuses_other_images(tmp_path):
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError, match="uint8"):
            demo.write_png(str(tmp_path / "bad.png"), bad)


def test_to_uint8_is_the_jax_conversion():
    rgb = torch.tensor([[[-0.5, 0.0, 0.0039]], [[0.5, 0.99999, 1.7]]], dtype=torch.float32)
    np.testing.assert_array_equal(demo.to_uint8(rgb), (np.clip(rgb.numpy(), 0, 1) * 255)
                                  .astype(np.uint8))
    np.testing.assert_array_equal(demo.to_uint8(rgb.numpy()), demo.to_uint8(rgb))


def test_pil_decodes_the_files(port_run):
    Image = pytest.importorskip("PIL.Image")
    out, images, _ = port_run
    for name in demo.IMAGES:
        with Image.open(out / f"{name}.png") as im:
            assert im.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(im), demo.to_uint8(images[name]))
