"""User-model packaging: the s2i-equivalent build layer (L6).

Port of seldon_tpu/packaging.py. Seldon's `wrappers/s2i/python/` builder
images run a script that execs `seldon-core-microservice $MODEL_NAME
$API_TYPE --service-type $SERVICE_TYPE --persistence $PERSISTENCE`.

Here the equivalent is a generated Dockerfile + entrypoint over a plain
model directory. The env-var contract is IDENTICAL (MODEL_NAME /
API_TYPE / SERVICE_TYPE / PERSISTENCE), so CRs and docs written for
Seldon port unchanged. The entrypoint execs the port's microservice. The
image installs PyTorch from its CPU wheel index; the accelerator variant
(`generate_dockerfile(tpu=True)`, the `--tpu` flag, names kept from the
JAX package) starts from a CUDA PyTorch devel image instead, whose
`nvcc` builds the port's kernels at first use. Everything else is the
JAX package's output, byte for byte (the translation table of
`operator/__init__.py`).

CLI:  python -m seldon_tpu_torch.packaging <model_dir> --model-name MyModel \
          [--service-type MODEL] [--api-type REST,GRPC] [--tpu] [--build]

Also here: graph TEMPLATES (L7 helm-chart equivalents of
seldon-single-model / seldon-abtest / seldon-mab) rendered straight to
SeldonDeployment dicts — `render_template("abtest", ...)`.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Optional

ENTRYPOINT = """\
#!/bin/sh -e
# seldon-tpu microservice entrypoint (env contract mirrors the reference
# s2i run script: wrappers/s2i/python/s2i/bin/run:11-20).
if [ -z "$MODEL_NAME" ] || [ -z "$SERVICE_TYPE" ]; then
    echo "Failed to find required env vars MODEL_NAME, SERVICE_TYPE" >&2
    exit 1
fi
cd /microservice
echo "starting seldon-tpu microservice"
exec python -m seldon_tpu_torch.runtime.microservice "$MODEL_NAME" \\
    --api-type "${API_TYPE:-REST,GRPC}" \\
    --service-type "$SERVICE_TYPE" \\
    --persistence "${PERSISTENCE:-0}" \\
    --tracing "${TRACING:-0}"
"""


# The accelerator image: PyTorch for CUDA with the toolkit (nvcc), which
# builds the port's kernels from the package's csrc/ at first use.
CUDA_BASE_IMAGE = "pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel"


def generate_entrypoint() -> str:
    return ENTRYPOINT


def generate_dockerfile(
    base_image: str = "python:3.12-slim",
    tpu: bool = False,
    requirements: bool = True,
    env: Optional[Dict[str, str]] = None,
) -> str:
    """Dockerfile text for a user model directory. The build context must
    contain the user's model module(s) (and optionally requirements.txt);
    the package itself is installed here. `tpu=True` selects the
    accelerator image: CUDA PyTorch with `nvcc` for the port's kernels.
    `env` (MODEL_NAME etc.) is baked in with ENV lines — the run script's
    contract is env-driven, so without them the container exits at boot
    (the reference s2i builder bakes its environment file the same way)."""
    if tpu:
        base_image = CUDA_BASE_IMAGE
    lines = [
        f"FROM {base_image}",
        "WORKDIR /microservice",
        "COPY . /microservice",
    ]
    if requirements:
        lines += [
            "RUN if [ -f requirements.txt ]; then "
            "pip install --no-cache-dir -r requirements.txt; fi",
        ]
    if not tpu:
        lines += ["RUN pip install --no-cache-dir torch "
                  "--index-url https://download.pytorch.org/whl/cpu"]
    lines += [
        "RUN pip install --no-cache-dir seldon-tpu",
        "COPY .seldon-tpu/run /run.sh",
        "RUN chmod +x /run.sh",
        "EXPOSE 9000 9500",
        'ENV PREDICTIVE_UNIT_SERVICE_PORT=9000',
    ]
    for k, v in (env or {}).items():
        lines.append(f"ENV {k}={v}")
    lines += ['CMD ["/run.sh"]']
    return "\n".join(lines) + "\n"


def package_model(
    model_dir: str,
    model_name: str,
    service_type: str = "MODEL",
    api_type: str = "REST,GRPC",
    tpu: bool = False,
    image_tag: Optional[str] = None,
    build: bool = False,
    language: str = "python",
) -> Dict[str, str]:
    """Write .seldon-tpu/{Dockerfile,run} into `model_dir`; optionally
    `docker build`. Returns the generated file paths.

    `language`: "python" (default, the port's full runtime), or "nodejs" /
    "r" / "java" — foreign units speaking the JSON unit protocol
    (docs/wrappers.md; reference wrappers/s2i/{nodejs,R,java})."""
    out_dir = os.path.join(model_dir, ".seldon-tpu")
    os.makedirs(out_dir, exist_ok=True)
    env = {
        "MODEL_NAME": model_name,
        "SERVICE_TYPE": service_type,
        "API_TYPE": api_type,
        "PERSISTENCE": "0",
    }
    env_path = os.path.join(out_dir, "environment")
    with open(env_path, "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in env.items()))
    if language != "python":
        gen = _FOREIGN_WRAPPERS.get(language)
        if gen is None:
            raise ValueError(
                f"unknown language {language!r}; have python, "
                + ", ".join(sorted(_FOREIGN_WRAPPERS))
            )
        files = gen()
        result = {"environment": env_path}
        for rel, content in files.items():
            path = os.path.join(out_dir, rel)
            with open(path, "w") as f:
                f.write(content if rel != "Dockerfile" else _bake_env(
                    content, env))
            result[rel.lower().replace(".", "_")
                   if rel != "Dockerfile" else "dockerfile"] = path
        dockerfile_path = result["dockerfile"]
    else:
        run_path = os.path.join(out_dir, "run")
        with open(run_path, "w") as f:
            f.write(generate_entrypoint())
        os.chmod(run_path, 0o755)
        dockerfile_path = os.path.join(out_dir, "Dockerfile")
        with open(dockerfile_path, "w") as f:
            f.write(generate_dockerfile(tpu=tpu, env=env))
        result = {"dockerfile": dockerfile_path, "run": run_path,
                  "environment": env_path}
    if build:
        if shutil.which("docker") is None:
            raise RuntimeError("docker not available for --build")
        tag = image_tag or f"seldon-tpu-model/{model_name.lower()}:latest"
        subprocess.run(
            ["docker", "build", "-f", dockerfile_path, "-t", tag, model_dir],
            check=True,
        )
        result["image"] = tag
    return result


# ---------------------------------------------------------------------------
# Foreign-language builders (reference wrappers/s2i/{R,nodejs})
# ---------------------------------------------------------------------------
#
# The reference ships full s2i builder images for R and NodeJS
# (wrappers/s2i/R/Dockerfile:1, wrappers/s2i/nodejs/Dockerfile:1). Here the
# equivalent is a generated serve shim + Dockerfile speaking the documented
# JSON unit protocol (docs/wrappers.md): REST routes /predict,
# /transform-input, /transform-output, /route, /aggregate, /send-feedback
# (+ /api/v0.1 and /api/v1.0 aliases), /live /ready /metrics, port from
# PREDICTIVE_UNIT_SERVICE_PORT, CR parameters from
# PREDICTIVE_UNIT_PARAMETERS, meta echoed through. The shims are original
# implementations against that protocol, not ports of the reference's.

NODE_MICROSERVICE = """\
// seldon-tpu NodeJS unit shim — JSON unit protocol (docs/wrappers.md).
// Zero dependencies: node's http module only. The user module (selected
// by MODEL_NAME) exports any of: init(params), predict(data, names,
// meta), transformInput(msg), transformOutput(msg), route(data, names),
// aggregate(msgs), sendFeedback(reward, request, truth).
'use strict';
const http = require('http');
const path = require('path');

const PORT = parseInt(process.env.PREDICTIVE_UNIT_SERVICE_PORT || '9000', 10);
const MODEL = process.env.MODEL_NAME || 'MyModel';
let params = [];
try { params = JSON.parse(process.env.PREDICTIVE_UNIT_PARAMETERS || '[]'); }
catch (e) { console.error('bad PREDICTIVE_UNIT_PARAMETERS:', e.message); }

const user = require(path.resolve('/microservice', MODEL));
if (typeof user.init === 'function') user.init(params);

let requestCount = 0;

function dataOf(msg) {
  const d = (msg && msg.data) || {};
  if (d.ndarray !== undefined) return { array: d.ndarray, names: d.names || [] };
  if (d.tensor !== undefined)
    return { array: d.tensor.values, shape: d.tensor.shape,
             names: d.names || [] };
  return { array: null, names: d.names || [] };
}

function respond(res, code, obj) {
  const body = JSON.stringify(obj);
  res.writeHead(code, { 'Content-Type': 'application/json' });
  res.end(body);
}

function outMessage(result, inMsg) {
  // Echo meta through; reply ndarray unless the user returned a full
  // SeldonMessage-shaped object ({data: ...} or {strData: ...}).
  if (result && (result.data !== undefined || result.strData !== undefined ||
                 result.binData !== undefined || result.jsonData !== undefined)) {
    result.meta = Object.assign({}, inMsg.meta, result.meta);
    return result;
  }
  return { meta: inMsg.meta || {},
           data: { names: (result && result.names) || [],
                   ndarray: (result && result.ndarray !== undefined)
                            ? result.ndarray : result } };
}

const handlers = {
  'predict': (msg) => {
    const { array, names } = dataOf(msg);
    return outMessage(user.predict(array, names, msg.meta || {}), msg);
  },
  'transform-input': (msg) =>
    outMessage(user.transformInput ? user.transformInput(msg)
                                   : dataOf(msg).array, msg),
  'transform-output': (msg) =>
    outMessage(user.transformOutput ? user.transformOutput(msg)
                                    : dataOf(msg).array, msg),
  'route': (msg) => {
    const { array, names } = dataOf(msg);
    const branch = user.route ? user.route(array, names) : -1;
    return { meta: msg.meta || {}, data: { ndarray: [[branch]] } };
  },
  'aggregate': (msgList) => {
    const msgs = (msgList && msgList.seldonMessages) || [];
    if (user.aggregate) return outMessage(user.aggregate(msgs), msgs[0] || {});
    return msgs[0] || {};
  },
  'send-feedback': (fb) => {
    if (user.sendFeedback)
      user.sendFeedback(fb.reward || 0, fb.request, fb.truth);
    return { meta: (fb.response && fb.response.meta) || {} };
  },
};

const server = http.createServer((req, res) => {
  const url = req.url.split('?')[0];
  if (req.method === 'GET') {
    if (url === '/live' || url === '/ready') return respond(res, 200, { status: 'ok' });
    if (url === '/metrics') {
      res.writeHead(200, { 'Content-Type': 'text/plain' });
      return res.end(
        '# TYPE unit_requests_total counter\\n' +
        'unit_requests_total ' + requestCount + '\\n');
    }
    return respond(res, 404, { error: 'not found' });
  }
  // POST /<verb> or /api/v0.1/<verb> or /api/v1.0/<verb>
  const verb = url.replace(/^\\/api\\/v[01]\\.[01]\\//, '').replace(/^\\//, '');
  const handler = handlers[verb];
  if (!handler) return respond(res, 404, { error: 'no route ' + url });
  let chunks = [];
  req.on('data', (c) => chunks.push(c));
  req.on('end', () => {
    requestCount += 1;
    let msg;
    try {
      const raw = Buffer.concat(chunks).toString() || '{}';
      const asForm = raw.startsWith('json=');
      msg = JSON.parse(asForm ? decodeURIComponent(raw.slice(5).replace(/\\+/g, ' ')) : raw);
    } catch (e) { return respond(res, 400, { error: 'bad json: ' + e.message }); }
    try { respond(res, 200, handler(msg)); }
    catch (e) { respond(res, 500, { error: e.message }); }
  });
});

server.listen(PORT, () => console.log(
  'seldon-tpu node unit ' + MODEL + ' listening on ' + PORT));
"""

R_MICROSERVICE = """\
# seldon-tpu R unit shim — JSON unit protocol (docs/wrappers.md).
# plumber-based like the reference R builder; the user file (selected by
# MODEL_NAME, sourced from /microservice/<MODEL_NAME>.R) defines any of:
#   model_init(params), model_predict(data, names), model_route(data,
#   names), model_transform_input(msg), model_transform_output(msg),
#   model_send_feedback(reward, request, truth)
library(plumber)
library(jsonlite)

port <- as.integer(Sys.getenv("PREDICTIVE_UNIT_SERVICE_PORT", "9000"))
model <- Sys.getenv("MODEL_NAME", "MyModel")
params <- tryCatch(
  fromJSON(Sys.getenv("PREDICTIVE_UNIT_PARAMETERS", "[]"),
           simplifyVector = FALSE),
  error = function(e) list())

source(file.path("/microservice", paste0(model, ".R")))
if (exists("model_init")) model_init(params)

data_of <- function(msg) {
  d <- msg$data
  if (!is.null(d$ndarray)) list(array = d$ndarray, names = d$names)
  else if (!is.null(d$tensor)) list(array = d$tensor$values,
                                    shape = d$tensor$shape, names = d$names)
  else list(array = NULL, names = d$names)
}

out_message <- function(result, in_msg) {
  if (is.list(result) && (!is.null(result$data) || !is.null(result$strData)))
    { result$meta <- in_msg$meta; return(result) }
  list(meta = if (is.null(in_msg$meta)) structure(list(), names = character(0))
              else in_msg$meta,
       data = list(ndarray = result))
}

parse_body <- function(req) {
  raw <- req$postBody
  if (startsWith(raw, "json=")) {
    raw <- URLdecode(gsub("\\\\+", " ", substring(raw, 6)))
  }
  fromJSON(raw, simplifyVector = TRUE, simplifyDataFrame = FALSE)
}

pr <- pr()

handle_verb <- function(verb, fn) {
  for (route in c(paste0("/", verb),
                  paste0("/api/v0.1/", verb), paste0("/api/v1.0/", verb))) {
    pr <<- pr_post(pr, route, fn, serializer = serializer_unboxed_json())
  }
}

handle_verb("predict", function(req, res) {
  msg <- parse_body(req)
  d <- data_of(msg)
  out_message(model_predict(d$array, d$names), msg)
})
handle_verb("transform-input", function(req, res) {
  msg <- parse_body(req)
  if (exists("model_transform_input"))
    out_message(model_transform_input(msg), msg)
  else out_message(data_of(msg)$array, msg)
})
handle_verb("transform-output", function(req, res) {
  msg <- parse_body(req)
  if (exists("model_transform_output"))
    out_message(model_transform_output(msg), msg)
  else out_message(data_of(msg)$array, msg)
})
handle_verb("route", function(req, res) {
  msg <- parse_body(req)
  d <- data_of(msg)
  branch <- if (exists("model_route")) model_route(d$array, d$names) else -1
  list(meta = msg$meta, data = list(ndarray = list(list(branch))))
})
handle_verb("aggregate", function(req, res) {
  msg_list <- parse_body(req)
  msgs <- msg_list$seldonMessages
  if (exists("model_aggregate")) out_message(model_aggregate(msgs),
                                             msgs[[1]])
  else msgs[[1]]
})
handle_verb("send-feedback", function(req, res) {
  fb <- parse_body(req)
  if (exists("model_send_feedback"))
    model_send_feedback(fb$reward, fb$request, fb$truth)
  list(meta = structure(list(), names = character(0)))
})

pr <- pr_get(pr, "/live", function() list(status = "ok"),
             serializer = serializer_unboxed_json())
pr <- pr_get(pr, "/ready", function() list(status = "ok"),
             serializer = serializer_unboxed_json())
request_count <- 0
pr <- pr_filter(pr, "count", function(req) {
  request_count <<- request_count + 1
  forward()
})
pr <- pr_get(pr, "/metrics", function(res) {
  res$setHeader("Content-Type", "text/plain")
  res$body <- paste0("# TYPE unit_requests_total counter\\n",
                     "unit_requests_total ", request_count, "\\n")
  res
}, serializer = serializer_text())

pr_run(pr, host = "0.0.0.0", port = port)
"""


def generate_node_wrapper() -> Dict[str, str]:
    """NodeJS unit image files: {relpath: content}. The user's model dir
    holds <MODEL_NAME>.js (CommonJS module per the shim's contract)."""
    dockerfile = "\n".join([
        "FROM node:20-slim",
        "WORKDIR /microservice",
        "COPY . /microservice",
        "RUN if [ -f package.json ]; then npm install --omit=dev; fi",
        "COPY .seldon-tpu/microservice.js /microservice/.seldon-tpu/",
        "EXPOSE 9000",
        "ENV PREDICTIVE_UNIT_SERVICE_PORT=9000",
        'CMD ["node", "/microservice/.seldon-tpu/microservice.js"]',
    ]) + "\n"
    return {"Dockerfile": dockerfile, "microservice.js": NODE_MICROSERVICE}


def generate_r_wrapper() -> Dict[str, str]:
    """R (plumber) unit image files: {relpath: content}. The user's model
    dir holds <MODEL_NAME>.R defining the model_* functions."""
    dockerfile = "\n".join([
        "FROM rocker/r-base",
        "RUN Rscript -e \"install.packages(c('plumber', 'jsonlite'))\"",
        "WORKDIR /microservice",
        "COPY . /microservice",
        "COPY .seldon-tpu/microservice.R /microservice/.seldon-tpu/",
        "EXPOSE 9000",
        "ENV PREDICTIVE_UNIT_SERVICE_PORT=9000",
        'CMD ["Rscript", "/microservice/.seldon-tpu/microservice.R"]',
    ]) + "\n"
    return {"Dockerfile": dockerfile, "microservice.R": R_MICROSERVICE}


JAVA_MICROSERVICE = """\
// seldon-tpu Java unit shim — JSON unit protocol (docs/wrappers.md).
// Zero dependencies: the JDK's com.sun.net.httpserver plus a minimal
// built-in JSON codec (the reference Java wrapper is a full Spring app;
// wrappers/s2i/java/). The user class (selected by MODEL_NAME, compiled
// from /microservice/<MODEL_NAME>.java) may define any of, resolved by
// reflection on the instance:
//   init(List params), predict(Object data, List names, Map meta),
//   transformInput(Map msg), transformOutput(Map msg),
//   route(Object data, List names), aggregate(List msgs),
//   sendFeedback(Double reward, Map request, Map truth)

import com.sun.net.httpserver.HttpExchange;
import com.sun.net.httpserver.HttpServer;
import java.io.OutputStream;
import java.lang.reflect.Method;
import java.net.InetSocketAddress;
import java.net.URLDecoder;
import java.nio.charset.StandardCharsets;
import java.util.ArrayList;
import java.util.LinkedHashMap;
import java.util.List;
import java.util.Map;
import java.util.concurrent.Executors;
import java.util.concurrent.atomic.AtomicLong;

public final class Microservice {
    static final Object ABSENT = new Object();
    static Object user;
    static final AtomicLong requests = new AtomicLong();

    static String env(String k, String d) {
        String v = System.getenv(k);
        return v == null || v.isEmpty() ? d : v;
    }

    public static void main(String[] args) throws Exception {
        int port = Integer.parseInt(env("PREDICTIVE_UNIT_SERVICE_PORT",
                                        "9000"));
        String model = env("MODEL_NAME", "MyModel");
        Object params;
        try {  // malformed operator-injected params must not kill boot
            params = Json.parse(env("PREDICTIVE_UNIT_PARAMETERS", "[]"));
        } catch (Exception e) {
            System.err.println("bad PREDICTIVE_UNIT_PARAMETERS ("
                    + e.getMessage() + "); continuing with []");
            params = new ArrayList<>();
        }
        user = Class.forName(model).getDeclaredConstructor().newInstance();
        call("init", params);
        HttpServer srv = HttpServer.create(new InetSocketAddress(port), 0);
        // Cached thread pool: the default (calling-thread) executor
        // serializes ALL requests, so one slow predict() would starve
        // /live and /ready into kubelet restarts.
        srv.setExecutor(Executors.newCachedThreadPool());
        srv.createContext("/", Microservice::handle);
        srv.start();
        System.out.println("seldon-tpu java unit " + model
                + " listening on " + srv.getAddress().getPort());
    }

    static Object call(String name, Object... args) throws Exception {
        for (Method m : user.getClass().getMethods()) {
            if (m.getName().equals(name)
                    && m.getParameterCount() == args.length) {
                return m.invoke(user, args);
            }
        }
        return ABSENT;
    }

    @SuppressWarnings("unchecked")
    static Map<String, Object> asMap(Object o) {
        return o instanceof Map ? (Map<String, Object>) o
                                : new LinkedHashMap<>();
    }

    // {values, names, shape} — shape is non-null only for tensor
    // payloads, mirroring the node/R shims' dataOf contract.
    static Object[] dataOf(Map<String, Object> msg) {
        Map<String, Object> d = asMap(msg.get("data"));
        Object names = d.containsKey("names") ? d.get("names")
                                              : new ArrayList<>();
        if (d.containsKey("ndarray"))
            return new Object[]{d.get("ndarray"), names, null};
        if (d.containsKey("tensor")) {
            Map<String, Object> t = asMap(d.get("tensor"));
            return new Object[]{t.get("values"), names, t.get("shape")};
        }
        return new Object[]{null, names, null};
    }

    static Map<String, Object> outMessage(Object result,
                                          Map<String, Object> inMsg) {
        Object names = new ArrayList<>();
        if (result instanceof Map) {
            Map<String, Object> r = asMap(result);
            if (r.containsKey("data") || r.containsKey("strData")
                    || r.containsKey("binData")
                    || r.containsKey("jsonData")) {
                Map<String, Object> meta = asMap(inMsg.get("meta"));
                meta.putAll(asMap(r.get("meta")));
                // copy: the user may hand back an immutable Map.of(...)
                Map<String, Object> full = new LinkedHashMap<>(r);
                full.put("meta", meta);  // echo meta through
                return full;
            }
            if (r.containsKey("ndarray")) {  // {names, ndarray} user shape
                if (r.containsKey("names")) names = r.get("names");
                result = r.get("ndarray");
            }
        }
        Map<String, Object> data = new LinkedHashMap<>();
        data.put("names", names);
        data.put("ndarray", result);
        Map<String, Object> out = new LinkedHashMap<>();
        out.put("meta", asMap(inMsg.get("meta")));
        out.put("data", data);
        return out;
    }

    static Object dispatch(String verb, Object body) throws Exception {
        Map<String, Object> msg = asMap(body);
        Object[] dn = dataOf(msg);
        switch (verb) {
            case "predict": {
                // Copied meta (the original is echoed back untouched)
                // carrying the tensor shape so flat `values` are
                // reshapeable user-side.
                Map<String, Object> meta =
                        new LinkedHashMap<>(asMap(msg.get("meta")));
                if (dn[2] != null) meta.put("shape", dn[2]);
                Object r = call("predict", dn[0], dn[1], meta);
                if (r == ABSENT)  // MODELs must implement predict — loud
                    throw new IllegalStateException(
                            "no predict(Object, List, Map) on user class");
                return outMessage(r, msg);
            }
            case "transform-input": {
                Object r = call("transformInput", msg);
                return outMessage(r == ABSENT ? dn[0] : r, msg);
            }
            case "transform-output": {
                Object r = call("transformOutput", msg);
                return outMessage(r == ABSENT ? dn[0] : r, msg);
            }
            case "route": {
                Object r = call("route", dn[0], dn[1]);
                // Routers answer [[branch]] per the unit protocol.
                List<Object> row = new ArrayList<>();
                row.add(r == ABSENT ? -1 : r);
                List<Object> branch = new ArrayList<>();
                branch.add(row);
                Map<String, Object> data = new LinkedHashMap<>();
                data.put("ndarray", branch);
                Map<String, Object> out = new LinkedHashMap<>();
                out.put("meta", asMap(msg.get("meta")));
                out.put("data", data);
                return out;
            }
            case "aggregate": {
                Object msgs = msg.containsKey("seldonMessages")
                        ? msg.get("seldonMessages") : new ArrayList<>();
                List<?> list = msgs instanceof List ? (List<?>) msgs
                                                    : new ArrayList<>();
                Object first = list.isEmpty() ? new LinkedHashMap<>()
                                              : list.get(0);
                Object r = call("aggregate", list);
                return r == ABSENT ? first : outMessage(r, asMap(first));
            }
            case "send-feedback": {
                call("sendFeedback", msg.get("reward"), msg.get("request"),
                     msg.get("truth"));
                Map<String, Object> out = new LinkedHashMap<>();
                out.put("meta", asMap(asMap(msg.get("response"))
                                      .get("meta")));
                return out;
            }
            default:
                return null;
        }
    }

    static void handle(HttpExchange ex) {
        try {
            String path = ex.getRequestURI().getPath();
            if ("GET".equals(ex.getRequestMethod())) {
                if ("/live".equals(path) || "/ready".equals(path)) {
                    reply(ex, 200, "{\\"status\\":\\"ok\\"}",
                          "application/json");
                } else if ("/metrics".equals(path)) {
                    reply(ex, 200,
                          "# TYPE unit_requests_total counter\\n"
                          + "unit_requests_total " + requests.get() + "\\n",
                          "text/plain");
                } else {
                    reply(ex, 404, "{\\"error\\":\\"not found\\"}",
                          "application/json");
                }
                return;
            }
            String verb = path.replaceFirst("^/api/v[01]\\\\.[01]/", "")
                              .replaceFirst("^/", "");
            String raw = new String(ex.getRequestBody().readAllBytes(),
                                    StandardCharsets.UTF_8);
            if (raw.startsWith("json=")) {
                raw = URLDecoder.decode(raw.substring(5),
                                        StandardCharsets.UTF_8);
            }
            requests.incrementAndGet();
            Object body;
            try {
                body = Json.parse(raw.isEmpty() ? "{}" : raw);
            } catch (Exception pe) {  // protocol parity: bad json is 400
                Map<String, Object> bad = new LinkedHashMap<>();
                bad.put("error", "bad json: " + pe.getMessage());
                reply(ex, 400, Json.write(bad), "application/json");
                return;
            }
            Object out = dispatch(verb, body);
            if (out == null) {
                Map<String, Object> nf = new LinkedHashMap<>();
                nf.put("error", "no route " + path);
                reply(ex, 404, Json.write(nf), "application/json");
            } else {
                reply(ex, 200, Json.write(out), "application/json");
            }
        } catch (Exception e) {
            Throwable cause = e;  // unwrap reflective user exceptions
            while (cause instanceof java.lang.reflect
                    .InvocationTargetException && cause.getCause() != null) {
                cause = cause.getCause();
            }
            Map<String, Object> err = new LinkedHashMap<>();
            err.put("error", cause.getMessage() == null
                    ? cause.toString() : cause.getMessage());
            try {
                reply(ex, 500, Json.write(err), "application/json");
            } catch (Exception ignored) { }
        }
    }

    static void reply(HttpExchange ex, int code, String body, String ctype)
            throws Exception {
        byte[] b = body.getBytes(StandardCharsets.UTF_8);
        ex.getResponseHeaders().set("Content-Type", ctype);
        ex.sendResponseHeaders(code, b.length);
        try (OutputStream os = ex.getResponseBody()) {
            os.write(b);
        }
    }

    /** Minimal JSON codec: objects->LinkedHashMap, arrays->ArrayList,
     *  numbers->Double, plus String/Boolean/null. */
    static final class Json {
        private final String s;
        private int i;
        private Json(String s) { this.s = s; }

        static Object parse(String s) {
            Json p = new Json(s);
            Object v = p.value();
            p.ws();
            if (p.i < p.s.length())
                throw new IllegalArgumentException("trailing json");
            return v;
        }

        private void ws() {
            while (i < s.length() && Character.isWhitespace(s.charAt(i))) i++;
        }

        private Object value() {
            ws();
            if (i >= s.length())
                throw new IllegalArgumentException("empty json");
            char c = s.charAt(i);
            if (c == '{') return object();
            if (c == '[') return array();
            if (c == '"') return string();
            if (s.startsWith("true", i)) { i += 4; return Boolean.TRUE; }
            if (s.startsWith("false", i)) { i += 5; return Boolean.FALSE; }
            if (s.startsWith("null", i)) { i += 4; return null; }
            return number();
        }

        private Map<String, Object> object() {
            Map<String, Object> m = new LinkedHashMap<>();
            i++; ws();
            if (i < s.length() && s.charAt(i) == '}') { i++; return m; }
            while (true) {
                ws();
                String k = string();
                ws();
                if (s.charAt(i++) != ':')
                    throw new IllegalArgumentException("expected :");
                m.put(k, value());
                ws();
                char c = s.charAt(i++);
                if (c == '}') return m;
                if (c != ',')
                    throw new IllegalArgumentException("expected , or }");
            }
        }

        private List<Object> array() {
            List<Object> l = new ArrayList<>();
            i++; ws();
            if (i < s.length() && s.charAt(i) == ']') { i++; return l; }
            while (true) {
                l.add(value());
                ws();
                char c = s.charAt(i++);
                if (c == ']') return l;
                if (c != ',')
                    throw new IllegalArgumentException("expected , or ]");
            }
        }

        private String string() {
            if (s.charAt(i) != '"')
                throw new IllegalArgumentException("expected string");
            StringBuilder b = new StringBuilder();
            i++;
            while (true) {
                char c = s.charAt(i++);
                if (c == '"') return b.toString();
                if (c == '\\\\') {
                    char e = s.charAt(i++);
                    switch (e) {
                        case 'n': b.append('\\n'); break;
                        case 't': b.append('\\t'); break;
                        case 'r': b.append('\\r'); break;
                        case 'b': b.append('\\b'); break;
                        case 'f': b.append('\\f'); break;
                        case 'u':
                            b.append((char) Integer.parseInt(
                                    s.substring(i, i + 4), 16));
                            i += 4;
                            break;
                        default: b.append(e);
                    }
                } else {
                    b.append(c);
                }
            }
        }

        private Double number() {
            int start = i;
            while (i < s.length()
                    && "+-0123456789.eE".indexOf(s.charAt(i)) >= 0) i++;
            return Double.parseDouble(s.substring(start, i));
        }

        static String write(Object v) {
            StringBuilder b = new StringBuilder();
            writeTo(v, b);
            return b.toString();
        }

        private static void writeTo(Object v, StringBuilder b) {
            if (v == null) { b.append("null"); return; }
            if (v instanceof String) {
                b.append('"');
                for (char c : ((String) v).toCharArray()) {
                    switch (c) {
                        case '"': b.append("\\\\\\""); break;
                        case '\\\\': b.append("\\\\\\\\"); break;
                        case '\\n': b.append("\\\\n"); break;
                        case '\\t': b.append("\\\\t"); break;
                        case '\\r': b.append("\\\\r"); break;
                        default:
                            if (c < 0x20) {
                                b.append(String.format("\\\\u%04x", (int) c));
                            } else {
                                b.append(c);
                            }
                    }
                }
                b.append('"');
            } else if (v instanceof Map) {
                b.append('{');
                boolean first = true;
                for (Map.Entry<?, ?> e : ((Map<?, ?>) v).entrySet()) {
                    if (!first) b.append(',');
                    first = false;
                    writeTo(String.valueOf(e.getKey()), b);
                    b.append(':');
                    writeTo(e.getValue(), b);
                }
                b.append('}');
            } else if (v instanceof List) {
                b.append('[');
                boolean first = true;
                for (Object e : (List<?>) v) {
                    if (!first) b.append(',');
                    first = false;
                    writeTo(e, b);
                }
                b.append(']');
            } else if (v instanceof Double && (((Double) v).isNaN()
                    || ((Double) v).isInfinite())) {
                b.append("null");  // JSON has no NaN/Infinity tokens
            } else if (v instanceof Double
                    && ((Double) v) == Math.floor((Double) v)
                    && Math.abs((Double) v) < 1e15) {
                b.append((long) (double) (Double) v);
            } else {
                b.append(v);  // numbers, booleans
            }
        }
    }
}
"""


def generate_java_wrapper() -> Dict[str, str]:
    """Java unit image files: {relpath: content}. The user's model dir
    holds <MODEL_NAME>.java (public class per the shim's reflection
    contract); both are compiled by javac in the image build — no Maven,
    no Spring (reference wrappers/s2i/java/ ships a Spring template)."""
    dockerfile = "\n".join([
        "FROM eclipse-temurin:21-jdk",
        "WORKDIR /microservice",
        "COPY . /microservice",
        "COPY .seldon-tpu/Microservice.java /microservice/.seldon-tpu/",
        "RUN javac -d /microservice/.seldon-tpu/classes "
        "/microservice/.seldon-tpu/Microservice.java "
        "$(find /microservice -maxdepth 1 -name '*.java')",
        "EXPOSE 9000",
        "ENV PREDICTIVE_UNIT_SERVICE_PORT=9000",
        'CMD ["java", "-cp", "/microservice/.seldon-tpu/classes", '
        '"Microservice"]',
    ]) + "\n"
    return {"Dockerfile": dockerfile, "Microservice.java": JAVA_MICROSERVICE}


_FOREIGN_WRAPPERS = {"nodejs": generate_node_wrapper, "r": generate_r_wrapper,
                     "java": generate_java_wrapper}


def _bake_env(dockerfile: str, env: Dict[str, str]) -> str:
    """Append the unit-contract ENV lines before CMD (the foreign shims
    are env-driven exactly like the python entrypoint)."""
    lines = dockerfile.rstrip("\n").split("\n")
    cmd = lines.pop()
    lines += [f"ENV {k}={v}" for k, v in env.items()]
    lines.append(cmd)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Graph templates (helm-chart equivalents)
# ---------------------------------------------------------------------------


def _unit(name: str, implementation: str = "", model_uri: str = "",
          image: str = "", type_: str = "MODEL",
          children: Optional[List[Dict]] = None) -> Dict:
    unit: Dict = {"name": name, "type": type_}
    if implementation:
        unit["implementation"] = implementation
    if model_uri:
        unit["modelUri"] = model_uri
    if children:
        unit["children"] = children
    return unit


def render_template(template: str, name: str, namespace: str = "default",
                    **kw) -> Dict:
    """SeldonDeployment dict for a named graph template.

    Templates (reference helm-charts/):
      single-model  (seldon-single-model): one MODEL
          kw: model_uri, implementation=JAX_SERVER, replicas=1, tpu=None
      abtest        (seldon-abtest): RANDOM_ABTEST router over two models
          kw: model_uri_a, model_uri_b, traffic split is router-level
      mab           (seldon-mab): EpsilonGreedy router over two models
          kw: model_uri_a, model_uri_b, epsilon=0.1
      outlier-transformer (seldon-od-transformer): detector TRANSFORMER
          in front of a model
          kw: model_uri, detector_class (e.g. seldon_tpu_torch.components.
          VAEDetector), detector_uri
    """
    if template == "single-model":
        graph = _unit(
            "model",
            implementation=kw.get("implementation", "JAX_SERVER"),
            model_uri=kw.get("model_uri", ""),
        )
        predictor: Dict = {
            "name": "default",
            "replicas": int(kw.get("replicas", 1)),
            "graph": graph,
        }
        if kw.get("tpu"):
            predictor["tpu"] = kw["tpu"]
        predictors = [predictor]
    elif template in ("abtest", "mab"):
        children = [
            _unit("model-a", implementation=kw.get("implementation", "JAX_SERVER"),
                  model_uri=kw.get("model_uri_a", "")),
            _unit("model-b", implementation=kw.get("implementation", "JAX_SERVER"),
                  model_uri=kw.get("model_uri_b", "")),
        ]
        if template == "abtest":
            router = _unit("ab-router", implementation="RANDOM_ABTEST",
                           type_="ROUTER", children=children)
            router["parameters"] = [
                {"name": "ratioA", "value": str(kw.get("ratio_a", 0.5)),
                 "type": "FLOAT"}
            ]
        else:
            router = _unit("eg-router", type_="ROUTER", children=children)
            router["image"] = kw.get(
                "router_image", "seldon-tpu/microservice:0.1.0"
            )
            router["parameters"] = [
                {"name": "n_branches", "value": "2", "type": "INT"},
                {"name": "epsilon",
                 "value": str(kw.get("epsilon", 0.1)), "type": "FLOAT"},
            ]
        predictors = [{"name": "default", "replicas": 1, "graph": router}]
    elif template == "outlier-transformer":
        model = _unit("model", implementation=kw.get("implementation", "JAX_SERVER"),
                      model_uri=kw.get("model_uri", ""))
        det = _unit("outlier-detector", type_="TRANSFORMER",
                    model_uri=kw.get("detector_uri", ""),
                    children=[model])
        det["image"] = kw.get("detector_image",
                              "seldon-tpu/microservice:0.1.0")
        predictors = [{"name": "default", "replicas": 1, "graph": det}]
    else:
        raise ValueError(
            f"unknown template {template!r}; have single-model, abtest, "
            "mab, outlier-transformer"
        )
    return {
        "apiVersion": "machinelearning.seldon.io/v1alpha3",
        "kind": "SeldonDeployment",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"name": name, "predictors": predictors},
    }


def main(argv=None) -> None:  # pragma: no cover - CLI entry
    import argparse

    parser = argparse.ArgumentParser(description="package a seldon-tpu model")
    parser.add_argument("model_dir")
    parser.add_argument("--model-name", required=True)
    parser.add_argument("--service-type", default="MODEL")
    parser.add_argument("--api-type", default="REST,GRPC")
    parser.add_argument("--tpu", action="store_true")
    parser.add_argument("--build", action="store_true")
    parser.add_argument("--image-tag", default=None)
    parser.add_argument("--language", default="python",
                        choices=["python", "nodejs", "r", "java"])
    args = parser.parse_args(argv)
    out = package_model(
        args.model_dir, args.model_name, args.service_type, args.api_type,
        tpu=args.tpu, image_tag=args.image_tag, build=args.build,
        language=args.language,
    )
    for k, v in out.items():
        print(f"{k}: {v}")


if __name__ == "__main__":  # pragma: no cover
    main()
