"""npz keys and ciphertexts cross between the JAX package and the port.

Both packages write the same format (JSON header with magic
``rustfhe_tpu`` and version 1, raw uint32 arrays), so a file written by
one loads in the other with the same words (tolerance zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import tlwe as jtlwe
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import PBS_TEST_PARAMS as J_PBS_TEST
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu.utils import serialization as jser
from rustfhe_tpu_torch import TFHE, _u32, gates, keys, params, tlwe
from rustfhe_tpu_torch.utils import serialization as ser

P = params.TEST_PARAMS


def _jax_keys(seed=8):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = jkeys.gen_secret_key(k1, J_TEST)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, sk, J_TEST, "matmul")
    return sk, np.asarray(bk_raw), np.asarray(ksk_raw)


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS", "PBS_TEST_PARAMS"])
def test_header_bytes_match_jax(name):
    from rustfhe_tpu import params as jparams

    got = ser._params_header(getattr(params, name))
    assert np.array_equal(got, jser._params_header(getattr(jparams, name)))
    assert ser._parse_header(got) == getattr(params, name)


def test_jax_written_files_load_in_the_port(tmp_path):
    jsk, bk_raw, ksk_raw = _jax_keys()
    jser.save_secret_key(str(tmp_path / "sk.npz"), jsk, J_TEST)
    jser.save_cloud_key_raw(str(tmp_path / "ck.npz"), bk_raw, ksk_raw, J_TEST)
    bits = jnp.array([0, 1, 1, 0, 1], jnp.uint32)
    jct = jtlwe.encrypt_binary(jax.random.PRNGKey(9), jsk.lv0, bits, J_TEST)
    jser.save_ciphertexts(str(tmp_path / "ct.npz"), jct, J_TEST)

    sk, p_sk = ser.load_secret_key(str(tmp_path / "sk.npz"), device="cpu")
    ck, p_ck = ser.load_cloud_key(str(tmp_path / "ck.npz"), "cpu")
    ct, p_ct = ser.load_ciphertexts(str(tmp_path / "ct.npz"), device="cpu")
    assert p_sk == p_ck == p_ct == P
    want_sk, want_ck = keys.from_jax_keys(np.asarray(jsk.lv0), np.asarray(jsk.lv1), bk_raw,
                                          ksk_raw, P, "cpu")
    assert torch.equal(sk.lv0, want_sk.lv0) and torch.equal(sk.lv1, want_sk.lv1)
    assert torch.equal(ck.bk, want_ck.bk) and torch.equal(ck.ksk, want_ck.ksk)
    assert np.array_equal(_u32.to_numpy(ct), np.asarray(jct))
    out = gates.hom_bootstrap(ck, gates.precombine("not", ct, params=P), params=P)
    assert tlwe.decrypt_binary(out, sk.lv0).tolist() == [1, 0, 0, 1, 0]


def test_port_written_files_load_in_jax(tmp_path):
    gen = torch.Generator().manual_seed(10)
    sk = keys.gen_secret_key(gen, P, "cpu")
    bk_raw, ksk_raw = keys.gen_cloud_key_raw(gen, sk, P)
    ct = tlwe.encrypt_binary(gen, sk.lv0, torch.tensor([1, 0, 1], dtype=torch.int32), P)
    ser.save_secret_key(str(tmp_path / "sk"), sk, P)  # ".npz" is added, as in JAX
    ser.save_cloud_key_raw(str(tmp_path / "ck.npz"), bk_raw, ksk_raw, P)
    ser.save_ciphertexts(str(tmp_path / "ct.npz"), ct, P)
    assert (tmp_path / "sk.npz").stat().st_mode & 0o777 == 0o600

    jsk, p_sk = jser.load_secret_key(str(tmp_path / "sk.npz"))
    jck, p_ck = jser.load_cloud_key(str(tmp_path / "ck.npz"), "matmul")
    jct, p_ct = jser.load_ciphertexts(str(tmp_path / "ct.npz"))
    assert p_sk == p_ck == p_ct == J_TEST
    assert np.array_equal(np.asarray(jsk.lv0), _u32.to_numpy(sk.lv0))
    assert np.array_equal(np.asarray(jsk.lv1), _u32.to_numpy(sk.lv1))
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert np.array_equal(z["bk"], _u32.to_numpy(bk_raw))
        assert np.array_equal(z["ksk"], _u32.to_numpy(ksk_raw))
    m = get_engine("matmul")
    assert np.array_equal(np.asarray(jck.bk),
                          np.asarray(m.prepare_trgsw(jnp.asarray(_u32.to_numpy(bk_raw)), J_TEST)))
    assert np.array_equal(np.asarray(jct), _u32.to_numpy(ct))
    assert np.asarray(jtlwe.decrypt_binary(jct, jsk.lv0)).tolist() == [1, 0, 1]


def test_bad_files_rejected(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, header=np.frombuffer(b'{"magic": "nope"}', dtype=np.uint8))
    with pytest.raises(ValueError, match="not a rustfhe_tpu file"):
        ser.load_secret_key(path, device="cpu")
    np.savez(path, header=np.frombuffer(b'{"magic": "rustfhe_tpu", "version": 2}',
                                        dtype=np.uint8))
    with pytest.raises(ValueError, match="unsupported version"):
        ser.load_ciphertexts(path, device="cpu")


def test_cached_keys_load_then_regenerate_on_param_mismatch(tmp_path, capsys):
    prefix = str(tmp_path / "kc")
    sk1, ck1 = ser.cached_keys(prefix, 1, P, device="cpu")
    assert (tmp_path / "kc.sk.npz").exists() and (tmp_path / "kc.ck.npz").exists()
    # Another seed loads the cache, word for word.
    sk2, ck2 = ser.cached_keys(prefix, 999, P, device="cpu", verbose=True)
    assert "loaded cached keys" in capsys.readouterr().out
    assert torch.equal(sk1.lv0, sk2.lv0) and torch.equal(sk1.lv1, sk2.lv1)
    assert torch.equal(ck1.bk, ck2.bk) and torch.equal(ck1.ksk, ck2.ksk)
    # Other parameters: the cache is regenerated for them, and JAX reads it.
    sk3, ck3 = ser.cached_keys(prefix, 999, params.PBS_TEST_PARAMS, device="cpu", verbose=True)
    assert "different params" in capsys.readouterr().out
    assert sk3.lv0.shape == (params.PBS_TEST_PARAMS.n,)
    _, p_after = jser.load_secret_key(f"{prefix}.sk.npz")
    assert p_after == J_PBS_TEST
    # An unreadable cache is regenerated too.
    (tmp_path / "kc.ck.npz").write_bytes(b"not a zip file")
    ser.cached_keys(prefix, 3, P, device="cpu", verbose=True)
    assert "unreadable" in capsys.readouterr().out
    assert ser.load_cloud_key(f"{prefix}.ck.npz", device="cpu")[1] == P


def test_context_keyfile_reuses_the_keys(tmp_path):
    prefix = str(tmp_path / "ctx")
    a = TFHE.new(21, P, device="cpu", keyfile=prefix)
    b = TFHE.new(22, P, device="cpu", keyfile=prefix, latency_mode=True)
    assert torch.equal(a.sk.lv0, b.sk.lv0)
    assert torch.equal(a.ck.bk, b.ck.bk.bk)
    x = a.encrypt([0, 1, 1, 0])
    assert b.decrypt(b.not_(x)).tolist() == [1, 0, 0, 1]


def test_loaders_default_to_the_card(tmp_path, monkeypatch):
    sk, ck = ser.cached_keys(str(tmp_path / "kc"), 4, P, device="cpu")
    ser.save_ciphertexts(str(tmp_path / "ct.npz"), torch.zeros((2, P.n + 1), dtype=torch.int32), P)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load, path in ((ser.load_secret_key, "kc.sk.npz"), (ser.load_cloud_key, "kc.ck.npz"),
                       (ser.load_ciphertexts, "ct.npz")):
        with pytest.raises(RuntimeError, match="is_available"):
            load(str(tmp_path / path))
    with pytest.raises(RuntimeError, match="is_available"):
        ser.cached_keys(str(tmp_path / "kc"), 4, P)
    assert torch.equal(ser.load_secret_key(str(tmp_path / "kc.sk.npz"), device="cpu")[0].lv0,
                       sk.lv0)
