"""Minimal AWS SigV4-signed HTTP client with the SDK default credential chain,
over the standard library.

boto3 / the AWS SDK are not installed, so the Rekognition and Bedrock
backends (parity with internal/rekognition/rekognition.go:33-78 and
internal/ai/*/: the reference uses aws-sdk-go-v2) sign requests directly.
The JAX package sends them with ``requests``; the port needs no HTTP
library beyond the standard one, so every request here goes through
:func:`http_request`, one function over ``urllib.request``. It returns the
status and the body for every HTTP answer, error statuses included
(``urllib`` raises ``HTTPError`` where ``requests`` returns the response),
and lets connection failures and timeouts raise as ``OSError``
(``URLError``, ``socket.timeout``). Two differences from ``requests`` are
deliberate: ``urllib`` asks for ``Accept-Encoding: identity`` and decodes
no gzip, and it verifies TLS against the system's CA bundle, not
certifi's.

Credential resolution mirrors aws-sdk-go-v2's ``config.LoadDefaultConfig``
(the reference's non-DEV path, rekognition.go:55-78), in the SDK's order:

1. static environment variables (AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY
   [+ AWS_SESSION_TOKEN]) — also the reference's DEV_MODE scheme,
2. web-identity role (AWS_WEB_IDENTITY_TOKEN_FILE + AWS_ROLE_ARN via STS
   AssumeRoleWithWebIdentity — EKS IRSA),
3. shared config/credentials files (~/.aws/*, AWS_PROFILE,
   AWS_SHARED_CREDENTIALS_FILE / AWS_CONFIG_FILE), including profiles that
   assume ``role_arn`` from a ``source_profile`` via STS AssumeRole,
4. ECS/container endpoint (AWS_CONTAINER_CREDENTIALS_RELATIVE_URI /
   _FULL_URI [+ _AUTHORIZATION_TOKEN]),
5. EC2 instance role via IMDSv2 (token PUT, then role credentials), with
   the IMDSv1 fallback.

``IMAGECLUST_STS_URL``, ``IMAGECLUST_ECS_BASE`` and
``AWS_EC2_METADATA_SERVICE_ENDPOINT`` move the STS, container and IMDS
endpoints; ``AWS_EC2_METADATA_DISABLED=true`` skips IMDS. Temporary
credentials cache process-wide and refresh 5 minutes before expiry, like
the SDK's credential cache.
"""

from __future__ import annotations

import configparser
import datetime
import hashlib
import hmac
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

__all__ = [
    "AwsCredentials",
    "resolve_credentials",
    "sign_request",
    "aws_post_json",
    "http_request",
    "AwsError",
]

_IMDS_BASE = "http://169.254.169.254"
_ECS_BASE = "http://169.254.170.2"
_STS_URL = "https://sts.amazonaws.com/"
_REFRESH_MARGIN_S = 300.0
_FORM = "application/x-www-form-urlencoded"


class AwsError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"AWS request failed: HTTP {status}: {body[:500]}")
        self.status = status
        self.body = body


def http_request(method: str, url: str, body: bytes | None = None,
                 headers: dict[str, str] | None = None,
                 timeout: float = 30.0) -> tuple[int, bytes]:
    """Send one HTTP request; return ``(status, body bytes)`` for every
    answer the server gives, 4xx and 5xx included. Connection failures and
    timeouts raise ``OSError``. Every cloud call of the port goes through
    this function, so a test replaces it alone."""
    req = urllib.request.Request(url, data=body, headers=dict(headers or {}),
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        with err:
            return err.code, err.read()


def _text(raw: bytes) -> str:
    return raw.decode("utf-8", "replace")


@dataclass(frozen=True)
class AwsCredentials:
    access_key: str
    secret_key: str
    session_token: str = ""
    expiry: float = 0.0  # unix epoch; 0 = static, never expires

    def expired(self, now: float | None = None) -> bool:
        if not self.expiry:
            return False
        return (now if now is not None else time.time()) > (
            self.expiry - _REFRESH_MARGIN_S
        )

    @classmethod
    def from_env(cls) -> "AwsCredentials":
        """Static env credentials only — the reference's DEV_MODE scheme
        (rekognition.go:37-53). Prefer :func:`resolve_credentials`."""
        ak = os.environ.get("AWS_ACCESS_KEY_ID", "")
        sk = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if not ak or not sk:
            raise AwsError(
                0,
                "AWS credentials not found in environment variables",
            )
        return cls(ak, sk, os.environ.get("AWS_SESSION_TOKEN", ""))


# --------------------------------------------------------------------------
# default credential chain
# --------------------------------------------------------------------------

_CACHE: AwsCredentials | None = None
_CACHE_LOCK = threading.Lock()


def resolve_credentials(force_refresh: bool = False) -> AwsCredentials:
    """Resolve credentials through the SDK default chain (module docstring);
    caches until 5 minutes before expiry. Thread-safe: concurrent labeler
    threads on a cold cache resolve once, not N times (no STS/IMDS
    thundering herd)."""
    global _CACHE
    if _CACHE is not None and not force_refresh and not _CACHE.expired():
        return _CACHE
    with _CACHE_LOCK:
        if _CACHE is not None and not force_refresh and not _CACHE.expired():
            return _CACHE
        for provider in (_from_static_env, _from_web_identity, _from_profile,
                         _from_container, _from_imds):
            creds = provider()
            if creds is not None:
                _CACHE = creds
                return creds
    raise AwsError(
        0,
        "no AWS credentials found: tried env, web identity, shared "
        "config/credentials profiles, container endpoint, and IMDSv2",
    )


def _from_static_env() -> AwsCredentials | None:
    ak = os.environ.get("AWS_ACCESS_KEY_ID", "")
    sk = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    if ak and sk:
        return AwsCredentials(ak, sk, os.environ.get("AWS_SESSION_TOKEN", ""))
    return None


def _parse_expiration(s: str) -> float:
    try:
        return datetime.datetime.fromisoformat(
            s.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return 0.0


def _creds_from_json(js: dict) -> AwsCredentials:
    return AwsCredentials(
        js["AccessKeyId"],
        js["SecretAccessKey"],
        js.get("Token", js.get("SessionToken", "")),
        _parse_expiration(js.get("Expiration", "")),
    )


def _sts_xml_credentials(xml_text: str) -> AwsCredentials:
    import xml.etree.ElementTree as ET

    root = ET.fromstring(xml_text)
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    node = root.find(f".//{ns}Credentials")
    if node is None:
        raise AwsError(0, "STS response missing Credentials")
    get = lambda k: node.findtext(f"{ns}{k}", default="")  # noqa: E731
    return AwsCredentials(
        get("AccessKeyId"), get("SecretAccessKey"), get("SessionToken"),
        _parse_expiration(get("Expiration")),
    )


def _from_web_identity() -> AwsCredentials | None:
    token_file = os.environ.get("AWS_WEB_IDENTITY_TOKEN_FILE", "")
    role_arn = os.environ.get("AWS_ROLE_ARN", "")
    if not token_file or not role_arn or not os.path.exists(token_file):
        return None
    with open(token_file) as fh:
        token = fh.read().strip()
    params = {
        "Action": "AssumeRoleWithWebIdentity",
        "Version": "2011-06-15",
        "RoleArn": role_arn,
        "RoleSessionName": os.environ.get(
            "AWS_ROLE_SESSION_NAME", "imageclust-tpu"),
        "WebIdentityToken": token,
    }
    # the bytes and content type that ``requests.post(data=params)`` sends
    status, raw = http_request(
        "POST", _sts_url(), urllib.parse.urlencode(params).encode(),
        {"Content-Type": _FORM}, timeout=10)
    if status // 100 != 2:
        raise AwsError(status, _text(raw))
    return _sts_xml_credentials(_text(raw))


def _sts_url() -> str:
    return os.environ.get("IMAGECLUST_STS_URL", _STS_URL)


def _from_profile() -> AwsCredentials | None:
    profile = os.environ.get("AWS_PROFILE", "default")
    cred_file = os.environ.get(
        "AWS_SHARED_CREDENTIALS_FILE",
        os.path.expanduser("~/.aws/credentials"),
    )
    conf_file = os.environ.get(
        "AWS_CONFIG_FILE", os.path.expanduser("~/.aws/config"))
    sections: dict[str, dict] = {}
    for path, is_config in ((cred_file, False), (conf_file, True)):
        if not os.path.exists(path):
            continue
        ini = configparser.ConfigParser()
        try:
            ini.read(path)
        except configparser.Error:
            continue
        for name in ini.sections():
            # config file prefixes non-default profiles with "profile "
            key = name.removeprefix("profile ") if is_config else name
            merged = sections.setdefault(key, {})
            for k, v in ini.items(name):
                merged.setdefault(k, v)
    sec = sections.get(profile)
    if not sec:
        return None
    if "role_arn" in sec:
        src = sections.get(sec.get("source_profile", ""), {})
        ak = src.get("aws_access_key_id")
        sk = src.get("aws_secret_access_key")
        if not ak or not sk:
            return None
        base = AwsCredentials(ak, sk, src.get("aws_session_token", ""))
        return _sts_assume_role(
            base, sec["role_arn"],
            sec.get("role_session_name", "imageclust-tpu"),
        )
    ak = sec.get("aws_access_key_id")
    sk = sec.get("aws_secret_access_key")
    if ak and sk:
        return AwsCredentials(ak, sk, sec.get("aws_session_token", ""))
    return None


def _sts_assume_role(base: AwsCredentials, role_arn: str,
                     session_name: str) -> AwsCredentials:
    body = urllib.parse.urlencode({
        "Action": "AssumeRole",
        "Version": "2011-06-15",
        "RoleArn": role_arn,
        "RoleSessionName": session_name,
    }).encode()
    url = _sts_url()
    headers = sign_request(
        "POST", url, "us-east-1", "sts", {"Content-Type": _FORM}, body, base,
    )
    status, raw = http_request("POST", url, body, headers, timeout=10)
    if status // 100 != 2:
        raise AwsError(status, _text(raw))
    return _sts_xml_credentials(_text(raw))


def _from_container() -> AwsCredentials | None:
    full = os.environ.get("AWS_CONTAINER_CREDENTIALS_FULL_URI", "")
    rel = os.environ.get("AWS_CONTAINER_CREDENTIALS_RELATIVE_URI", "")
    if not full and not rel:
        return None
    url = full or (_ecs_base() + rel)
    headers = {}
    tok = os.environ.get("AWS_CONTAINER_AUTHORIZATION_TOKEN", "")
    if tok:
        headers["Authorization"] = tok
    status, raw = http_request("GET", url, None, headers, timeout=5)
    if status // 100 != 2:
        raise AwsError(status, _text(raw))
    return _creds_from_json(json.loads(raw))


def _ecs_base() -> str:
    return os.environ.get("IMAGECLUST_ECS_BASE", _ECS_BASE)


def _imds_base() -> str:
    return os.environ.get(
        "AWS_EC2_METADATA_SERVICE_ENDPOINT", _IMDS_BASE).rstrip("/")


def _from_imds() -> AwsCredentials | None:
    if os.environ.get("AWS_EC2_METADATA_DISABLED", "").lower() == "true":
        return None
    base = _imds_base()
    try:
        # IMDSv2 first; fall back to v1 when the token PUT fails (e.g. a
        # container behind the default hop limit of 1 gets 403/timeouts) —
        # the SDK's fallback behavior, without which instance roles break
        # on common EC2 setups.
        h = {}
        try:
            status, raw = http_request(
                "PUT", f"{base}/latest/api/token", None,
                {"X-aws-ec2-metadata-token-ttl-seconds": "21600"},
                timeout=1.0,
            )
            if status // 100 == 2 and raw:
                h = {"X-aws-ec2-metadata-token": _text(raw)}
        except Exception:
            pass  # v1 fallback below still probes the role endpoint
        status, raw = http_request(
            "GET", f"{base}/latest/meta-data/iam/security-credentials/",
            None, h, timeout=1.0,
        )
        if status // 100 != 2 or not _text(raw).strip():
            return None  # e.g. 404: an instance without a role
        role = _text(raw).strip().splitlines()[0]
        _, raw = http_request(
            "GET", f"{base}/latest/meta-data/iam/security-credentials/{role}",
            None, h, timeout=1.0,
        )
        js = json.loads(raw)
    except Exception:  # not on EC2 (connection refused / timeout)
        return None
    if js.get("Code", "Success") != "Success":
        return None
    return _creds_from_json(js)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_request(
    method: str,
    url: str,
    region: str,
    service: str,
    headers: dict[str, str],
    body: bytes,
    creds: AwsCredentials,
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """Return ``headers`` plus Authorization/X-Amz-* per AWS SigV4."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date_stamp = now.strftime("%Y%m%d")

    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    canonical_uri = urllib.parse.quote(parsed.path or "/")
    canonical_query = parsed.query  # assumed pre-canonical (we use none)

    payload_hash = hashlib.sha256(body).hexdigest()
    all_headers = {
        **{k.lower(): v.strip() for k, v in headers.items()},
        "host": host,
        "x-amz-date": amz_date,
    }
    if creds.session_token:
        all_headers["x-amz-security-token"] = creds.session_token
    signed_names = sorted(all_headers)
    canonical_headers = "".join(f"{k}:{all_headers[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)

    canonical_request = "\n".join(
        [method, canonical_uri, canonical_query, canonical_headers,
         signed_headers, payload_hash]
    )
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope,
         hashlib.sha256(canonical_request.encode()).hexdigest()]
    )
    k = _hmac(("AWS4" + creds.secret_key).encode(), date_stamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()

    out = dict(headers)
    out["X-Amz-Date"] = amz_date
    if creds.session_token:
        out["X-Amz-Security-Token"] = creds.session_token
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


def aws_post_json(
    url: str,
    region: str,
    service: str,
    payload: dict | bytes,
    target: str | None = None,
    content_type: str = "application/x-amz-json-1.1",
    creds: AwsCredentials | None = None,
    timeout: float = 30.0,
) -> dict:
    """Signed POST returning parsed JSON; raises AwsError on non-2xx and
    on a 2xx body that is not JSON (the namers' retry loops take it as
    they take ``requests``' JSONDecodeError, an ``OSError``, in the JAX
    package)."""
    creds = creds or resolve_credentials()
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    headers = {"Content-Type": content_type}
    if target:
        headers["X-Amz-Target"] = target
    signed = sign_request("POST", url, region, service, headers, body, creds)
    status, raw = http_request("POST", url, body, signed, timeout)
    if status // 100 != 2:
        raise AwsError(status, _text(raw))
    try:
        return json.loads(raw)
    except ValueError:
        raise AwsError(status,
                       "unparseable JSON body: " + _text(raw)) from None
