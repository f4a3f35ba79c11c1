"""Training DBs across the two packages: a DB of reference-format CPM Datums
(genLMDB's layout, ``training/cpm_lmdb.py``) or of pose records
(``training/pose_db.py``) written by the JAX package reads in the port and
the other way round, every record identical (image, mask_miss, people,
scale); the port's kvdb is byte for byte the JAX package's, and its LevelDB
reader reads what the JAX writer wrote."""

import numpy as np
import pytest

from caffe_rtpose_tpu.training import cpm_lmdb as JC
from caffe_rtpose_tpu.training import pose_db as JP
from caffe_rtpose_tpu.training.transformer import Meta as JMeta
from caffe_rtpose_tpu.training.transformer import Person as JPerson
from caffe_rtpose_tpu.utils import db as jdb
from caffe_rtpose_tpu_torch.proto import datum
from caffe_rtpose_tpu_torch.training import cpm_lmdb as PC
from caffe_rtpose_tpu_torch.training import pose_db as PP
from caffe_rtpose_tpu_torch.training.transformer import Meta, Person
from caffe_rtpose_tpu_torch.utils import db as pdb


def _records(meta_cls, person_cls, n=4, joints=17, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = 96, 128
        img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        mask = ((rs.rand(h, w) > 0.2) * 255).astype(np.uint8)
        people = []
        for _ in range(1 + i % 3):
            j = rs.uniform(-5, 130, size=(joints, 2)).astype(np.float32)
            v = rs.choice([0, 1, 3], size=joints).astype(np.int32)
            people.append(person_cls(j, v, j.mean(0).astype(np.float32)))
        out.append((img, meta_cls(people=people, scale_self=float(rs.uniform(0.5, 1.5))), mask))
    return out


def _same_item(a, b):
    (ia, ma, ka), (ib, mb, kb) = a, b
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ka, kb)
    assert np.float32(ma.scale_self) == np.float32(mb.scale_self)
    assert len(ma.people) == len(mb.people)
    for pa, pb in zip(ma.people, mb.people):
        np.testing.assert_array_equal(pa.joints, pb.joints)
        np.testing.assert_array_equal(pa.visible, pb.visible)
        np.testing.assert_array_equal(pa.objpos, pb.objpos)


@pytest.mark.parametrize("to_ours", [True, False])
def test_cpm_db_jax_written_port_read(tmp_path, to_ours):
    path = str(tmp_path / "jax_cpm.kvdb")
    assert JC.write_cpm_db(_records(JMeta, JPerson), path) == 4
    js, ps = JC.CpmDatumSource(path, to_ours=to_ours), PC.CpmDatumSource(path, to_ours=to_ours)
    assert len(js) == len(ps) == 4
    for i in range(4):
        _same_item(ps[i], js[i])


def test_cpm_db_port_written_jax_read(tmp_path):
    path = str(tmp_path / "port_cpm.kvdb")
    assert PC.write_cpm_db(_records(Meta, Person), path) == 4
    js, ps = JC.CpmDatumSource(path), PC.CpmDatumSource(path)
    for i in range(4):
        _same_item(ps[i], js[i])
    # the same records written by either package are the same file
    other = str(tmp_path / "jax_cpm.kvdb")
    JC.write_cpm_db(_records(JMeta, JPerson), other)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_datum_codec_matches_jax():
    from caffe_rtpose_tpu.proto import datum as jdatum

    img, meta, mask = _records(Meta, Person, n=1)[0]
    d = PC.encode_cpm_datum(img, meta, mask_miss=mask)
    jd = JC.encode_cpm_datum(img, meta, mask_miss=mask)
    assert datum.serialize_datum(d) == jdatum.serialize_datum(jd)
    arr = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    assert datum.serialize_datum(datum.array_to_datum(arr, 3)) == jdatum.serialize_datum(
        jdatum.array_to_datum(arr, 3))


def test_pose_db_both_ways(tmp_path):
    """Pose kvdb records (JSON header + PNG image and mask): OpenCV's PNG
    (JAX) reads in the port, the port's numpy PNG reads in JAX."""
    recs = _records(Meta, Person, joints=18, seed=1)
    for name, enc, db_mod in (("jax", JP._encode_record, jdb), ("port", PP._encode_record, pdb)):
        path = str(tmp_path / f"{name}_pose.kvdb")
        db = db_mod.open_db(path, "w", backend="kvdb")
        txn = db.new_transaction()
        for i, (img, meta, mask) in enumerate(recs):
            txn.put(f"{i:08d}", enc(img, meta, mask))
        txn.commit()
        db.close()
        js, ps = JP.PoseDbSource(path), PP.PoseDbSource(path)
        assert len(js) == len(ps) == len(recs)
        for i in range(len(recs)):
            _same_item(ps[i], js[i])
            _same_item(ps[i], recs[i])


def test_leveldb_reader_reads_jax_writes(tmp_path):
    path = str(tmp_path / "ldb")
    items = [(f"{i:05d}".encode(), bytes([i % 251]) * (i + 3)) for i in range(40)]
    db = jdb.open_db(path, "w", backend="leveldb")
    txn = db.new_transaction()
    for k, v in items:
        txn.put(k, v)
    txn.commit()
    db.close()
    port = pdb.open_db(path, "r")
    assert port.backend == "leveldb" and len(port) == len(items)
    cur = port.new_cursor()
    cur.seek_to_first()
    got = []
    while cur.valid():
        got.append((cur.key(), cur.value()))
        cur.next()
    assert got == items
