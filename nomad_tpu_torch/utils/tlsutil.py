"""TLS material generation and socket wrapping.

Reference behavior: helper/tlsutil/config.go builds the agent's mTLS
configs (CA-verified HTTPS + RPC, optional verify_https_client), and
the operator generates cluster certs with a CA. Here: a minimal CA +
cert issuer over the `cryptography` package, plus ssl.SSLContext
builders for the HTTP agent (server side) and the SDK (client side).
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def generate_ca(common_name: str = "nomad-tpu CA",
                days: int = 1825) -> Tuple[bytes, bytes]:
    """Self-signed CA; returns (cert_pem, key_pem)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - datetime.timedelta(minutes=5))
        .not_valid_after(_now() + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .add_extension(
            x509.KeyUsage(digital_signature=True, key_cert_sign=True,
                          crl_sign=True, content_commitment=False,
                          key_encipherment=False, data_encipherment=False,
                          key_agreement=False, encipher_only=False,
                          decipher_only=False),
            critical=True)
        .sign(key, hashes.SHA256())
    )
    return (
        cert.public_bytes(serialization.Encoding.PEM),
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


def generate_cert(ca_cert_pem: bytes, ca_key_pem: bytes,
                  common_name: str,
                  san_dns: Optional[List[str]] = None,
                  san_ips: Optional[List[str]] = None,
                  days: int = 365,
                  server: bool = True,
                  client: bool = True) -> Tuple[bytes, bytes]:
    """CA-signed leaf cert; returns (cert_pem, key_pem).

    The reference's convention: server certs carry the
    `server.<region>.nomad` name the RPC layer verifies; pass it in
    san_dns the same way. localhost/127.0.0.1 are always included so
    dev agents verify.
    """
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    key = ec.generate_private_key(ec.SECP256R1())
    sans: List[x509.GeneralName] = [x509.DNSName("localhost")]
    for d in (san_dns or []):
        sans.append(x509.DNSName(d))
    for ip in ["127.0.0.1"] + list(san_ips or []):
        sans.append(x509.IPAddress(ipaddress.ip_address(ip)))
    ekus = []
    if server:
        ekus.append(ExtendedKeyUsageOID.SERVER_AUTH)
    if client:
        ekus.append(ExtendedKeyUsageOID.CLIENT_AUTH)
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(_now() - datetime.timedelta(minutes=5))
        .not_valid_after(_now() + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.ExtendedKeyUsage(ekus), critical=False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    return (
        cert.public_bytes(serialization.Encoding.PEM),
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


@dataclass
class TLSConfig:
    """Agent TLS block (config tls{} stanza; tlsutil/config.go)."""

    enabled: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    #: require client certs on the HTTPS API (mTLS)
    verify_https_client: bool = False

    def write_bundle(self, directory: str, ca: Tuple[bytes, bytes],
                     cert: Tuple[bytes, bytes]) -> "TLSConfig":
        """Persist generated material and point this config at it."""
        os.makedirs(directory, exist_ok=True)
        paths = {}
        for name, data in (("ca.pem", ca[0]), ("ca-key.pem", ca[1]),
                           ("cert.pem", cert[0]), ("key.pem", cert[1])):
            p = os.path.join(directory, name)
            with open(p, "wb") as f:
                f.write(data)
            os.chmod(p, 0o600)
            paths[name] = p
        self.ca_file = paths["ca.pem"]
        self.cert_file = paths["cert.pem"]
        self.key_file = paths["key.pem"]
        self.enabled = True
        return self


def server_context(cfg: TLSConfig) -> ssl.SSLContext:
    """SSLContext for the HTTP agent's listener."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.verify_https_client:
        ctx.load_verify_locations(cfg.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(ca_file: str, cert_file: str = "",
                   key_file: str = "") -> ssl.SSLContext:
    """SSLContext for SDK/CLI connections (NOMAD_CACERT /
    NOMAD_CLIENT_CERT / NOMAD_CLIENT_KEY)."""
    ctx = ssl.create_default_context(cafile=ca_file or None)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    if cert_file and key_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx
