"""The port's Mina layer (mina/: base58, the legacy and kimchi hashers,
Schnorr signatures, tx_type) against the JAX package's on
tests/test_mina.py's inputs. Host code on both sides: every comparison is
exact."""

import random

import pytest

from proof_systems_tpu.mina import base58 as jb58
from proof_systems_tpu.mina import hasher as jhasher
from proof_systems_tpu.mina import signer as jsigner
from proof_systems_tpu.mina import tx_type as jtx
from proof_systems_tpu_torch.curves import Pallas
from proof_systems_tpu_torch.mina import base58 as b58
from proof_systems_tpu_torch.mina import hasher
from proof_systems_tpu_torch.mina import signer
from proof_systems_tpu_torch.mina import tx_type as tx

SECKEY_B58 = "EKFXH5yESt7nsD1TJy5WNb4agVczkvzPRVexKQ8qYdNqauQRA8Ef"


def _roi(mod, rng):
    """The same ROInput built in either package: every append kind."""
    roi = mod.ROInput()
    roi.append_field(rng.randrange(Pallas.base.p))
    roi.append_scalar(rng.randrange(Pallas.scalar.p))
    roi.append_bool(True).append_u32(rng.randrange(1 << 32)).append_u64(rng.randrange(1 << 64))
    roi.append_bytes(bytes(rng.randrange(256) for _ in range(5)))
    return roi


def test_sign_fields_reference_vectors():
    """signer/tests/signer.rs sign_fields_test, in the port, and the same
    signatures as the JAX package on both networks."""
    kp = signer.Keypair(b58.seckey_from_base58(SECKEY_B58))
    jkp = jsigner.Keypair(jb58.seckey_from_base58(SECKEY_B58))
    roi = hasher.ROInput().append_field(1).append_field(2).append_field(3)
    jroi = jhasher.ROInput().append_field(1).append_field(2).append_field(3)

    t = signer.schnorr_sign(kp, roi, signer.NETWORK_TESTNET)
    assert t.rx == 20765817320000234273433345899587917625188885976914380365037035465312392849949
    assert t.s == 1002418623751815063744079415040141105602079382674393704838141255389705661040
    m = signer.schnorr_sign(kp, roi, signer.NETWORK_MAINNET)
    assert m.rx == 10877800556133241279092798070541266482295945495262263128372065874115589660865
    assert m.s == 7997465488592693587273287555462893250665854535708979748937792736327059812287
    for sig, net in ((t, signer.NETWORK_TESTNET), (m, signer.NETWORK_MAINNET)):
        j = jsigner.schnorr_sign(jkp, jroi, net)
        assert (sig.rx, sig.s) == (j.rx, j.s)
        assert signer.schnorr_verify(sig, kp.public, roi, net)
    assert not signer.schnorr_verify(t, kp.public, roi, signer.NETWORK_MAINNET)
    bad = signer.Signature(rx=t.rx, s=(t.s + 1) % (2**254))
    assert not signer.schnorr_verify(bad, kp.public, roi, signer.NETWORK_TESTNET)


@pytest.mark.parametrize("legacy", [False, True], ids=["kimchi", "legacy"])
def test_signatures_and_nonces_match(legacy):
    rng = random.Random(5)
    for net in (signer.NETWORK_TESTNET, signer.NETWORK_MAINNET):
        sk = rng.randrange(1, Pallas.scalar.p)
        state = rng.getstate()
        roi = _roi(hasher, rng)
        rng.setstate(state)
        jroi = _roi(jhasher, rng)
        kp, jkp = signer.Keypair(sk), jsigner.Keypair(sk)
        assert kp.public == jkp.public
        assert signer.derive_nonce(kp, roi, net) == jsigner.derive_nonce(jkp, jroi, net)
        sig = signer.schnorr_sign(kp, roi, net, legacy=legacy)
        j = jsigner.schnorr_sign(jkp, jroi, net, legacy=legacy)
        assert (sig.rx, sig.s) == (j.rx, j.s)
        assert signer.schnorr_verify(sig, kp.public, roi, net, legacy=legacy)
        assert jsigner.schnorr_verify(j, jkp.public, jroi, net, legacy=legacy)


def test_base58_roundtrip_matches():
    sec = b58.seckey_from_base58(SECKEY_B58)
    assert sec == jb58.seckey_from_base58(SECKEY_B58)
    assert b58.seckey_to_base58(sec) == SECKEY_B58
    rng = random.Random(9)
    for sk in [sec] + [rng.randrange(1, Pallas.scalar.p) for _ in range(3)]:
        pub = signer.Keypair(sk).public
        addr = b58.pubkey_to_address(pub)
        assert addr.startswith("B62")
        assert addr == jb58.pubkey_to_address(pub)
        assert b58.pubkey_from_address(addr) == pub
        assert b58.seckey_to_base58(sk) == jb58.seckey_to_base58(sk)
    data = bytes(range(40))
    assert b58.b58_encode(data) == jb58.b58_encode(data)
    assert b58.b58_decode(b58.b58_encode(b"\x00\x00ab")) == b"\x00\x00ab"


def test_roinput_packing_matches():
    roi = hasher.ROInput().append_field(42).append_bool(True).append_u32(7)
    fields = roi.to_fields()
    assert fields[0] == 42
    assert fields[1] == 1 | (7 << 1)
    assert len(roi.to_bytes()) == (255 + 33 + 7) // 8
    rng = random.Random(3)
    for _ in range(3):
        state = rng.getstate()
        a = _roi(hasher, rng)
        rng.setstate(state)
        b = _roi(jhasher, rng)
        assert a.to_fields() == b.to_fields()
        assert a.to_bytes() == b.to_bytes()
        assert a.append_roinput(a).to_fields() == b.append_roinput(b).to_fields()


@pytest.mark.parametrize("kind", ["kimchi", "legacy"])
def test_hashes_match(kind):
    rng = random.Random(7)
    for domain in ("CodaSignature", "MinaSignatureMainnet", None, "CoinbaseTest"):
        state = rng.getstate()
        roi = _roi(hasher, rng)
        rng.setstate(state)
        jroi = _roi(jhasher, rng)
        h = hasher.poseidon_hasher(kind, domain)
        jh = jhasher.poseidon_hasher(kind, domain)
        assert h.hash(roi) == jh.hash(jroi)
        assert h.hash(roi) == h.hash(roi)  # a reusable context
        if domain is not None:
            assert hasher.domain_prefix_to_field(domain) == jhasher.domain_prefix_to_field(domain)
    roi = hasher.ROInput().append_field(5)
    hs = {hasher.create_kimchi("CodaSignature").hash(roi),
          hasher.create_kimchi("MinaSignatureMainnet").hash(roi),
          hasher.create_legacy("CodaSignature").hash(roi)}
    assert len(hs) == 3


def test_tx_type_currency_semantics():
    """mina-tx-type/src/currency.rs: u64 checked arithmetic, sign-magnitude
    Signed with zero normalized to positive (tests/test_mina.py's cases)."""
    Amount, Fee, Sign, Signed = tx.Amount, tx.Fee, tx.Sign, tx.Signed
    a = Amount.new(720_000_000_000)
    assert a.inner() == 720_000_000_000 and not a.is_zero()
    assert Amount.new(0).is_zero()
    assert a.checked_add(Amount((1 << 64) - 1)) is None
    assert Amount(3).checked_sub(Amount(5)) is None
    assert Amount(5).abs_diff(Amount(3)) == Amount(2)
    assert Amount.new(Fee.new(7).inner()) == Fee(7).to_amount()
    assert Signed.new(Amount(0), Sign.NEG).sign is Sign.POS
    assert Signed.pos(Amount(10)).checked_add(Signed.neg(Amount(4))) == Signed.pos(Amount(6))
    assert Signed.pos(Amount(4)).checked_add(Signed.neg(Amount(10))) == Signed.neg(Amount(6))
    s = Signed.neg(Amount(4)).checked_sub(Signed.neg(Amount(4)))
    assert s is not None and s.is_zero() and s.is_pos()
    assert (-Signed.pos(Amount(3))).is_neg()
    assert Signed.pos(Amount((1 << 64) - 1)).checked_add(Signed.pos(Amount(1))) is None
    assert str(Signed.neg(Amount(6))) == str(jtx.Signed.neg(jtx.Amount(6)))
    assert str(Amount(6)) == str(jtx.Amount(6))


def test_tx_type_coinbase_matches():
    """coinbase.rs: net_amount, the fee transfer, and the ROInput that the
    hasher takes, field for field and hash for hash as in the JAX package."""
    def build(m, s):
        producer = m.CompressedPubKey.from_point(s.Keypair(123).public)
        worker = m.CompressedPubKey.from_point(s.Keypair(456).public)
        ft = m.CoinbaseFeeTransfer(worker, m.Fee.new(10_000_000))
        return (producer, m.Coinbase.new(producer, m.Amount.new(720_000_000_000)),
                m.Coinbase.with_fee_transfer(producer, m.Amount.new(720_000_000_000), ft),
                m.Coinbase.with_fee_transfer(producer, m.Amount(5),
                                             m.CoinbaseFeeTransfer(worker, m.Fee(6))))

    producer, cb, cb2, bad = build(tx, signer)
    jproducer, jcb, jcb2, jbad = build(jtx, jsigner)
    assert producer.decompress() == signer.Keypair(123).public == jproducer.decompress()
    assert not cb.has_fee_transfer() and cb2.has_fee_transfer()
    assert cb.net_amount() == tx.Amount(720_000_000_000)
    assert cb2.net_amount() == tx.Amount(720_000_000_000 - 10_000_000)
    assert bad.net_amount() is None and jbad.net_amount() is None
    assert tx.CompressedPubKey.empty().to_roinput().to_fields() == \
        jtx.CompressedPubKey.empty().to_roinput().to_fields()
    for c, j in ((cb, jcb), (cb2, jcb2)):
        roi, jroi = c.to_roinput(), j.to_roinput()
        assert roi.to_fields() == jroi.to_fields()
        assert roi.to_bytes() == jroi.to_bytes()
        h = hasher.create_kimchi("CoinbaseTest").hash(roi)
        assert h == jhasher.create_kimchi("CoinbaseTest").hash(jroi)
        assert 0 < h < Pallas.base.p
    assert cb2.to_roinput().to_bytes() != cb.to_roinput().to_bytes()
