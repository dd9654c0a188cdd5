"""The port's SigV4 client and credential chain (``imageclust_tpu_torch/
utils/aws.py``, over ``urllib``) against the JAX package's (over
``requests``).

Both packages sign byte-identically over a grid of requests, and resolve
credentials from the same local 127.0.0.1 server (STS, the container
endpoint and IMDS through their override variables): the credentials, and
the requests the server recorded (method, path, body and the signed
headers), must be equal. No test leaves the machine: the "not on EC2" case
points IMDS at a closed local port.
"""

import datetime
import json
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import imageclust_tpu.utils.aws as jaws
import imageclust_tpu_torch.utils.aws as paws

torch.set_num_threads(1)

FIXED_NOW = datetime.datetime(2026, 3, 4, 5, 6, 7,
                              tzinfo=datetime.timezone.utc)

_STS_XML = """<AssumeRoleWithWebIdentityResponse
  xmlns="https://sts.amazonaws.com/doc/2011-06-15/">
  <AssumeRoleWithWebIdentityResult>
    <Credentials>
      <AccessKeyId>ASIAWEB</AccessKeyId>
      <SecretAccessKey>websecret</SecretAccessKey>
      <SessionToken>webtoken</SessionToken>
      <Expiration>2099-01-01T00:00:00Z</Expiration>
    </Credentials>
  </AssumeRoleWithWebIdentityResult>
</AssumeRoleWithWebIdentityResponse>"""

_ASSUME_XML = _STS_XML.replace("WithWebIdentity", "").replace(
    "ASIAWEB", "ASIAROLE").replace("websecret", "rolesecret").replace(
    "webtoken", "roletoken")

_ECS_JSON = {"AccessKeyId": "AKECS", "SecretAccessKey": "SKECS",
             "Token": "ecstoken", "Expiration": "2099-01-01T00:00:00Z"}
_IMDS_JSON = {"Code": "Success", "AccessKeyId": "AKIMDS",
              "SecretAccessKey": "SKIMDS", "Token": "imdscreds",
              "Expiration": "2099-01-01T00:00:00Z"}

# headers each HTTP client adds on its own, outside what the chain sends
_TRANSPORT_HEADERS = {"user-agent", "accept-encoding", "accept",
                      "connection"}


class _Endpoints:
    """STS, the container endpoint and IMDS on one local server. Each
    request is recorded; the answers follow the attributes."""

    def __init__(self):
        self.log = []
        self.ecs_status = 200
        self.sts_status = 200
        self.token_status = 200
        self.roles_status = 200
        self.status_body = b""
        endpoints = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _answer(self, status, body, ctype="text/plain"):
                if isinstance(body, str):
                    body = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client timed out (test_timeout_is_oserror)

            def _handle(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                endpoints.log.append({
                    "method": self.command, "path": self.path, "body": body,
                    "headers": {k.lower(): v for k, v in
                                self.headers.items()}})
                path = self.path
                if path.startswith("/status/"):
                    code = int(path.split("/")[2])
                    return self._answer(code, endpoints.status_body)
                if path == "/slow":
                    time.sleep(1.0)
                    return self._answer(200, "late")
                if path == "/sts/":
                    if endpoints.sts_status != 200:
                        return self._answer(endpoints.sts_status,
                                            "<Error>denied</Error>")
                    form = urllib.parse.parse_qs(body.decode())
                    xml = (_STS_XML if form["Action"] == [
                        "AssumeRoleWithWebIdentity"] else _ASSUME_XML)
                    return self._answer(200, xml, "text/xml")
                if path.startswith("/v2/credentials/"):
                    if endpoints.ecs_status != 200:
                        return self._answer(endpoints.ecs_status, "ecs down")
                    return self._answer(200, json.dumps(_ECS_JSON),
                                        "application/json")
                if path == "/latest/api/token":
                    if endpoints.token_status != 200:
                        return self._answer(endpoints.token_status, "")
                    return self._answer(200, "imds-token")
                if path == "/latest/meta-data/iam/security-credentials/":
                    if endpoints.roles_status != 200:
                        return self._answer(endpoints.roles_status,
                                            "Not Found")
                    return self._answer(200, "my-instance-role\n")
                if path.endswith("/my-instance-role"):
                    return self._answer(200, json.dumps(_IMDS_JSON),
                                        "application/json")
                return self._answer(404, "no route")

            do_GET = do_PUT = do_POST = _handle

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


@pytest.fixture()
def endpoints():
    ep = _Endpoints()
    yield ep
    ep.close()
    assert not ep.thread.is_alive()


def _closed_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


@pytest.fixture(autouse=True)
def clean_chain(monkeypatch, tmp_path):
    """Isolate every test from the machine's environment, both packages'
    credential caches and the clock."""
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
                "AWS_SESSION_TOKEN", "AWS_WEB_IDENTITY_TOKEN_FILE",
                "AWS_ROLE_ARN", "AWS_ROLE_SESSION_NAME", "AWS_PROFILE",
                "AWS_CONTAINER_CREDENTIALS_RELATIVE_URI",
                "AWS_CONTAINER_CREDENTIALS_FULL_URI",
                "AWS_CONTAINER_AUTHORIZATION_TOKEN", "IMAGECLUST_STS_URL",
                "IMAGECLUST_ECS_BASE", "AWS_EC2_METADATA_SERVICE_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE",
                       str(tmp_path / "credentials"))
    monkeypatch.setenv("AWS_CONFIG_FILE", str(tmp_path / "config"))
    monkeypatch.setenv("AWS_EC2_METADATA_DISABLED", "true")
    for mod in (jaws, paws):
        monkeypatch.setattr(mod, "_CACHE", None)
        sign = mod.sign_request
        monkeypatch.setattr(
            mod, "sign_request",
            lambda *a, _sign=sign, **k: _sign(*a, **{"now": FIXED_NOW, **k}))
    yield


def _comparable(rec: dict):
    """A recorded request as the chain sent it: a SigV4 request by its
    signed headers and signature, any other by its headers less those the
    HTTP client adds on its own."""
    h = rec["headers"]
    auth = h.get("authorization", "")
    if auth.startswith("AWS4-HMAC-SHA256"):
        names = auth.split("SignedHeaders=")[1].split(",")[0].split(";")
        headers = {k: h[k] for k in names}
        headers["authorization"] = auth
    else:
        headers = {k: v for k, v in h.items() if k not in _TRANSPORT_HEADERS}
    return rec["method"], rec["path"], rec["body"], headers


def _resolve(mod, endpoints, monkeypatch):
    monkeypatch.setattr(mod, "_CACHE", None)
    if endpoints is not None:
        endpoints.log.clear()
    try:
        c = mod.resolve_credentials()
        out = ("ok", c.access_key, c.secret_key, c.session_token, c.expiry)
    except mod.AwsError as exc:
        out = ("error", exc.status, str(exc))
    sent = [] if endpoints is None else [_comparable(r)
                                         for r in endpoints.log]
    return out, sent


# -- the chain's 11 cases (tests/test_aws_chain.py) and the IMDS/STS/ECS
# branches that differ between requests and urllib ----------------------------

def _case_env_wins(mp, tmp_path, ep):
    mp.setenv("AWS_ACCESS_KEY_ID", "AKENV")
    mp.setenv("AWS_SECRET_ACCESS_KEY", "SKENV")
    return ("ok", "AKENV", "SKENV", "", 0.0)


def _case_nothing_found(mp, tmp_path, ep):
    return "no AWS credentials found"


def _case_web_identity(mp, tmp_path, ep):
    tok = tmp_path / "token"
    tok.write_text("oidc+jwt/with=odd chars&x\n")
    mp.setenv("AWS_WEB_IDENTITY_TOKEN_FILE", str(tok))
    mp.setenv("AWS_ROLE_ARN", "arn:aws:iam::1:role/pod")
    mp.setenv("IMAGECLUST_STS_URL", ep.base + "/sts/")
    return "ASIAWEB"


def _case_credentials_file(mp, tmp_path, ep):
    (tmp_path / "credentials").write_text(
        "[default]\naws_access_key_id=AKFILE\n"
        "aws_secret_access_key=SKFILE\naws_session_token=TOK\n")
    return ("ok", "AKFILE", "SKFILE", "TOK", 0.0)


def _case_config_profile(mp, tmp_path, ep):
    (tmp_path / "config").write_text(
        "[profile prod]\naws_access_key_id=AKPROD\n"
        "aws_secret_access_key=SKPROD\n")
    mp.setenv("AWS_PROFILE", "prod")
    return ("ok", "AKPROD", "SKPROD", "", 0.0)


def _case_role_arn_profile(mp, tmp_path, ep):
    (tmp_path / "credentials").write_text(
        "[base]\naws_access_key_id=AKBASE\n"
        "aws_secret_access_key=SKBASE\naws_session_token=BASETOK\n"
        "[default]\nrole_arn=arn:aws:iam::1:role/admin\n"
        "source_profile=base\nrole_session_name=sess one\n")
    mp.setenv("IMAGECLUST_STS_URL", ep.base + "/sts/")
    return "ASIAROLE"


def _case_container(mp, tmp_path, ep):
    mp.setenv("AWS_CONTAINER_CREDENTIALS_RELATIVE_URI", "/v2/credentials/abc")
    mp.setenv("AWS_CONTAINER_AUTHORIZATION_TOKEN", "Bearer x")
    mp.setenv("IMAGECLUST_ECS_BASE", ep.base)
    return "AKECS"


def _case_container_full_uri(mp, tmp_path, ep):
    mp.setenv("AWS_CONTAINER_CREDENTIALS_FULL_URI",
              ep.base + "/v2/credentials/full")
    return "AKECS"


def _case_imds_v2(mp, tmp_path, ep):
    mp.setenv("AWS_EC2_METADATA_DISABLED", "false")
    mp.setenv("AWS_EC2_METADATA_SERVICE_ENDPOINT", ep.base + "/")
    return "AKIMDS"


def _case_imds_v1_fallback(mp, tmp_path, ep):
    """The token PUT gets a 403 (urllib raises HTTPError there): both fall
    back to IMDSv1, asking without a token."""
    ep.token_status = 403
    mp.setenv("AWS_EC2_METADATA_DISABLED", "false")
    mp.setenv("AWS_EC2_METADATA_SERVICE_ENDPOINT", ep.base)
    return "AKIMDS"


def _case_imds_role_404(mp, tmp_path, ep):
    """An instance without a role: the role list is a 404, a clean miss."""
    ep.roles_status = 404
    mp.setenv("AWS_EC2_METADATA_DISABLED", "false")
    mp.setenv("AWS_EC2_METADATA_SERVICE_ENDPOINT", ep.base)
    return "no AWS credentials found"


def _case_not_on_ec2(mp, tmp_path, ep):
    mp.setenv("AWS_EC2_METADATA_DISABLED", "false")
    mp.setenv("AWS_EC2_METADATA_SERVICE_ENDPOINT",
              f"http://127.0.0.1:{_closed_port()}")
    return "no AWS credentials found"


def _case_container_500(mp, tmp_path, ep):
    ep.ecs_status = 500
    mp.setenv("AWS_CONTAINER_CREDENTIALS_RELATIVE_URI", "/v2/credentials/x")
    mp.setenv("IMAGECLUST_ECS_BASE", ep.base)
    return ("error", 500)


def _case_sts_403(mp, tmp_path, ep):
    ep.sts_status = 403
    tok = tmp_path / "token"
    tok.write_text("jwt")
    mp.setenv("AWS_WEB_IDENTITY_TOKEN_FILE", str(tok))
    mp.setenv("AWS_ROLE_ARN", "arn:aws:iam::1:role/pod")
    mp.setenv("IMAGECLUST_STS_URL", ep.base + "/sts/")
    return ("error", 403)


_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_env_wins, _case_nothing_found, _case_web_identity,
    _case_credentials_file, _case_config_profile, _case_role_arn_profile,
    _case_container, _case_container_full_uri, _case_imds_v2,
    _case_imds_v1_fallback, _case_imds_role_404, _case_not_on_ec2,
    _case_container_500, _case_sts_403)}


class TestChainAgainstJax:
    @pytest.mark.parametrize("case", sorted(_CASES))
    def test_same_credentials_and_requests(self, case, endpoints,
                                           monkeypatch, tmp_path):
        want_hint = _CASES[case](monkeypatch, tmp_path, endpoints)
        want, want_sent = _resolve(jaws, endpoints, monkeypatch)
        got, got_sent = _resolve(paws, endpoints, monkeypatch)
        assert got == want
        assert got_sent == want_sent
        # the case reached the branch it names
        if isinstance(want_hint, tuple) and want_hint[0] == "ok":
            assert got == want_hint
        elif isinstance(want_hint, tuple):
            assert got[:2] == want_hint
        elif want_hint.startswith("no AWS"):
            assert got[0] == "error" and want_hint in got[2]
        else:
            assert got[0] == "ok" and got[1] == want_hint
            assert got[4] > time.time()  # a temporary credential

    def test_assume_role_is_signed_by_the_source_profile(
            self, endpoints, monkeypatch, tmp_path):
        _case_role_arn_profile(monkeypatch, tmp_path, endpoints)
        _resolve(paws, endpoints, monkeypatch)
        (rec,) = endpoints.log
        assert rec["headers"]["authorization"].startswith(
            "AWS4-HMAC-SHA256 Credential=AKBASE/20260304/us-east-1/sts/")
        assert rec["headers"]["x-amz-security-token"] == "BASETOK"
        assert rec["headers"]["content-type"] == (
            "application/x-www-form-urlencoded")

    def test_imdsv2_token_first(self, endpoints, monkeypatch, tmp_path):
        _case_imds_v2(monkeypatch, tmp_path, endpoints)
        _resolve(paws, endpoints, monkeypatch)
        methods = [(r["method"], r["path"]) for r in endpoints.log]
        assert methods[0] == ("PUT", "/latest/api/token")
        assert endpoints.log[0]["headers"][
            "x-aws-ec2-metadata-token-ttl-seconds"] == "21600"
        assert all(r["headers"]["x-aws-ec2-metadata-token"] == "imds-token"
                   for r in endpoints.log[1:])

    @pytest.mark.parametrize("mod", [jaws, paws], ids=["jax", "port"])
    def test_caches_until_near_expiry(self, mod, monkeypatch):
        calls = {"n": 0}

        def counting_env():
            calls["n"] += 1
            return mod.AwsCredentials("AK", "SK", expiry=time.time() + 3600)

        monkeypatch.setattr(mod, "_from_static_env", counting_env)
        a = mod.resolve_credentials()
        b = mod.resolve_credentials()
        assert a is b and calls["n"] == 1
        mod.resolve_credentials(force_refresh=True)
        assert calls["n"] == 2

    @pytest.mark.parametrize("mod", [jaws, paws], ids=["jax", "port"])
    def test_refreshes_expired(self, mod, monkeypatch):
        calls = {"n": 0}

        def counting_env():
            calls["n"] += 1
            return mod.AwsCredentials("AK", "SK", expiry=time.time() + 1)

        monkeypatch.setattr(mod, "_from_static_env", counting_env)
        mod.resolve_credentials()
        mod.resolve_credentials()  # inside the 5-min margin -> re-resolve
        assert calls["n"] == 2

    def test_cold_cache_resolves_once_across_threads(self, monkeypatch):
        """Labeler threads on a cold cache resolve the chain once (the
        lock), however the interpreter interleaves them."""
        import sys

        calls = {"n": 0}

        def slow_env():
            calls["n"] += 1
            time.sleep(0.01)
            return paws.AwsCredentials("AK", "SK", expiry=time.time() + 3600)

        monkeypatch.setattr(paws, "_from_static_env", slow_env)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            out = []
            threads = [threading.Thread(
                target=lambda: out.append(paws.resolve_credentials()))
                for _ in range(32)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert calls["n"] == 1 and len(out) == 32
        assert all(c is out[0] for c in out)

    def test_from_env(self, monkeypatch):
        for mod in (jaws, paws):
            with pytest.raises(mod.AwsError, match="not found"):
                mod.AwsCredentials.from_env()
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "A")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "S")
        monkeypatch.setenv("AWS_SESSION_TOKEN", "T")
        got = paws.AwsCredentials.from_env()
        want = jaws.AwsCredentials.from_env()
        assert (got.access_key, got.secret_key, got.session_token) == (
            want.access_key, want.secret_key, want.session_token)

    @pytest.mark.parametrize("text", ["2099-01-01T00:00:00Z",
                                      "2030-06-01T12:30:00+02:00", "", "junk"])
    def test_parse_expiration(self, text):
        assert paws._parse_expiration(text) == jaws._parse_expiration(text)


# -- SigV4 --------------------------------------------------------------------

_URLS = (
    "https://rekognition.us-east-1.amazonaws.com/",
    "https://rekognition.us-east-1.amazonaws.com",
    "https://bedrock-runtime.us-west-2.amazonaws.com/model/"
    "anthropic.claude-3-haiku-20240307-v1%3A0/invoke",
    "https://bedrock-runtime.us-west-2.amazonaws.com/model/us.amazon.nova"
    "-micro-v1:0/invoke",
    "https://example.amazonaws.com/a b/c~d/été/x+y",
    "https://sts.amazonaws.com/?Action=GetCallerIdentity&Version=2011-06-15",
    "http://127.0.0.1:8080/sts/",
)
_HEADERS = (
    {},
    {"Content-Type": "application/x-amz-json-1.1",
     "X-Amz-Target": "RekognitionService.DetectLabels"},
    {"content-type": "  application/json ", "X-Custom": "a  b"},
)


@pytest.mark.parametrize("method", ["GET", "POST", "PUT"])
@pytest.mark.parametrize("url", _URLS)
@pytest.mark.parametrize("headers", _HEADERS, ids=["none", "target", "spaces"])
@pytest.mark.parametrize("token", ["", "session/token+="])
def test_sign_request_byte_identical(method, url, headers, token):
    body = b'{"MaxLabels": 10}' if method != "GET" else b""
    got = paws.sign_request(method, url, "us-east-1", "rekognition",
                            dict(headers), body,
                            paws.AwsCredentials("AKID", "SECRET", token))
    want = jaws.sign_request(method, url, "us-east-1", "rekognition",
                             dict(headers), body,
                             jaws.AwsCredentials("AKID", "SECRET", token))
    assert got == want
    assert got["X-Amz-Date"] == "20260304T050607Z"
    assert ("X-Amz-Security-Token" in got) == bool(token)


_header_names = st.sampled_from(["Content-Type", "X-Amz-Target", "x-extra",
                                 "X-AMZ-META-K"])
_header_values = st.text(st.characters(min_codepoint=32, max_codepoint=126),
                         max_size=12)


@settings(max_examples=60, deadline=None)
@given(path=st.text(st.characters(min_codepoint=33, max_codepoint=0x2FF,
                                  exclude_characters="?#"), max_size=16),
       headers=st.dictionaries(_header_names, _header_values, max_size=3),
       body=st.binary(max_size=64),
       region=st.sampled_from(["us-east-1", "us-west-2", "eu-central-1"]),
       service=st.sampled_from(["rekognition", "bedrock", "sts"]),
       token=st.sampled_from(["", "tok"]),
       seconds=st.integers(0, 10 ** 9))
def test_sign_request_hypothesis(path, headers, body, region, service, token,
                                 seconds):
    now = datetime.datetime.fromtimestamp(seconds, datetime.timezone.utc)
    url = "https://h.amazonaws.com/" + path
    got = paws.sign_request("POST", url, region, service, dict(headers),
                            body, paws.AwsCredentials("A", "S", token),
                            now=now)
    want = jaws.sign_request("POST", url, region, service, dict(headers),
                             body, jaws.AwsCredentials("A", "S", token),
                             now=now)
    assert got == want


# -- the transport: where requests and urllib differ --------------------------

class TestTransport:
    @pytest.mark.parametrize("status", [400, 403, 404, 429, 500, 503])
    def test_error_status_is_returned(self, endpoints, status):
        """urllib raises HTTPError on a non-2xx answer; the transport
        returns the status and body, as requests does."""
        endpoints.status_body = b'{"message": "nope"}'
        url = f"{endpoints.base}/status/{status}"
        got = paws.http_request("GET", url, None, {}, 5)
        want = requests.get(url, timeout=5)
        assert got == (want.status_code, want.content) == (
            status, b'{"message": "nope"}')

    def test_connection_refused_is_oserror(self):
        with pytest.raises(OSError):
            paws.http_request("GET", f"http://127.0.0.1:{_closed_port()}/",
                              None, {}, 2)

    def test_timeout_is_oserror(self, endpoints):
        with pytest.raises(OSError):
            paws.http_request("GET", endpoints.base + "/slow", None, {}, 0.2)

    def test_form_body_bytes_equal_requests(self):
        """``requests.post(data=dict)`` form-encodes; the port sends
        ``urlencode(params).encode()`` with the same content type."""
        params = {"Action": "AssumeRoleWithWebIdentity",
                  "RoleArn": "arn:aws:iam::1:role/p q",
                  "WebIdentityToken": "a+b/c=d&e é漢"}
        prep = requests.Request("POST", "http://h/", data=params).prepare()
        assert urllib.parse.urlencode(params).encode() == prep.body.encode()
        assert prep.headers["Content-Type"] == paws._FORM

    def test_identity_encoding_and_post_body(self, endpoints):
        """urllib asks for ``Accept-Encoding: identity`` (a deliberate
        difference: requests asks for gzip and decodes it) and sends the
        body and headers it is given."""
        status, _ = paws.http_request(
            "POST", f"{endpoints.base}/status/200", b"\x00\x01body",
            {"Content-Type": "application/json", "X-Amz-Target": "T"}, 5)
        assert status == 200
        (rec,) = endpoints.log
        assert rec["headers"]["accept-encoding"] == "identity"
        assert rec["body"] == b"\x00\x01body"
        assert rec["headers"]["content-type"] == "application/json"
        assert rec["headers"]["x-amz-target"] == "T"
        assert rec["headers"]["content-length"] == "6"

    def test_put_without_body_sends_zero_length(self, endpoints):
        """The IMDSv2 token PUT has no body; both clients send
        ``Content-Length: 0``."""
        url = f"{endpoints.base}/latest/api/token"
        paws.http_request("PUT", url, None, {"X-A": "1"}, 5)
        requests.put(url, headers={"X-A": "1"}, timeout=5)
        got, want = endpoints.log
        assert got["headers"]["content-length"] == want["headers"][
            "content-length"] == "0"


class TestAwsPostJson:
    """``aws_post_json`` through a recorder at each package's seam (the
    port's ``http_request``, the JAX package's ``requests.post``)."""

    @pytest.fixture()
    def seams(self, monkeypatch):
        sent = {"jax": [], "port": []}
        answer = {"status": 200, "body": b'{"Labels": []}'}

        def port_http(method, url, body, headers, timeout):
            sent["port"].append((method, url, body, dict(headers), timeout))
            return answer["status"], answer["body"]

        def jax_post(url, data=None, headers=None, timeout=None):
            sent["jax"].append(("POST", url, data, dict(headers), timeout))
            return _response(answer["status"], answer["body"])

        monkeypatch.setattr(paws, "http_request", port_http)
        monkeypatch.setattr(requests, "post", jax_post)
        return sent, answer

    @pytest.mark.parametrize("payload", [
        {"Image": {"Bytes": "AAAA"}, "MaxLabels": 10, "MinConfidence": 75.0},
        b'{"raw": true}',
        {"unicode": "é漢", "nested": [1, 2.5, None]}])
    @pytest.mark.parametrize("target",
                             [None, "RekognitionService.DetectLabels"])
    @pytest.mark.parametrize("token", ["", "tok"])
    def test_same_request(self, seams, payload, target, token):
        sent, _ = seams
        args = dict(url="https://rekognition.us-east-1.amazonaws.com/",
                    region="us-east-1", service="rekognition",
                    payload=payload, target=target)
        got = paws.aws_post_json(**args, creds=paws.AwsCredentials(
            "AK", "SK", token))
        want = jaws.aws_post_json(**args, creds=jaws.AwsCredentials(
            "AK", "SK", token))
        assert got == want == {"Labels": []}
        assert sent["port"] == sent["jax"]
        assert sent["port"][0][4] == 30.0

    @pytest.mark.parametrize("status", [400, 403, 429, 500])
    def test_error_status_raises_aws_error(self, seams, status):
        _, answer = seams
        answer.update(status=status, body=b'{"__type": "Throttling"}')
        errs = []
        for mod in (paws, jaws):
            with pytest.raises(mod.AwsError) as info:
                mod.aws_post_json("https://h/", "r", "s", {},
                                  creds=mod.AwsCredentials("A", "S"))
            errs.append((info.value.status, info.value.body, str(info.value)))
        assert errs[0] == errs[1]
        assert errs[0][0] == status

    def test_unparseable_body(self, seams):
        """A 2xx body that is not JSON: requests raises its
        JSONDecodeError (an OSError), the port an AwsError; the namers'
        retry loops take either."""
        _, answer = seams
        answer["body"] = b"<html>not json</html>"
        with pytest.raises(paws.AwsError, match="unparseable JSON"):
            paws.aws_post_json("https://h/", "r", "s", {},
                               creds=paws.AwsCredentials("A", "S"))
        with pytest.raises(OSError):
            jaws.aws_post_json("https://h/", "r", "s", {},
                               creds=jaws.AwsCredentials("A", "S"))

    def test_resolves_credentials_when_none_given(self, seams, monkeypatch):
        sent, _ = seams
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKENV")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "SKENV")
        paws.aws_post_json("https://h/", "r", "s", {"a": 1})
        jaws.aws_post_json("https://h/", "r", "s", {"a": 1})
        assert sent["port"] == sent["jax"]
        assert "Credential=AKENV/" in sent["port"][0][3]["Authorization"]


def _response(status: int, body: bytes) -> requests.Response:
    resp = requests.Response()
    resp.status_code = status
    resp._content = body
    resp.encoding = "utf-8"
    return resp
