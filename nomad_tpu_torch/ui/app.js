"use strict";

/* ---------- plumbing ---------- */

const $view = document.getElementById("view");
let refreshTimer = null;

function token() { return localStorage.getItem("nomad_token") || ""; }
function namespaceQS() {
  const ns = localStorage.getItem("nomad_namespace") || "";
  return ns ? `namespace=${encodeURIComponent(ns)}` : "";
}

async function api(path, opts = {}) {
  const headers = Object.assign({}, opts.headers);
  if (token()) headers["X-Nomad-Token"] = token();
  const sep = path.includes("?") ? "&" : "?";
  const ns = namespaceQS();
  const url = ns && path.startsWith("/v1/") && !path.includes("namespace=")
    ? path + sep + ns : path;
  const resp = await fetch(url, Object.assign({}, opts, { headers }));
  if (!resp.ok) {
    let msg = `HTTP ${resp.status}`;
    try { msg = (await resp.json()).error || msg; } catch (e) { /* raw */ }
    throw new Error(msg);
  }
  const text = await resp.text();
  return text ? JSON.parse(text) : null;
}
const get = (p) => api(p);
const post = (p, body) => api(p, { method: "POST", body: JSON.stringify(body || {}) });
const del = (p) => api(p, { method: "DELETE" });

function esc(s) {
  return String(s ?? "").replace(/[&<>"']/g,
    (c) => ({ "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;" }[c]));
}
/* for values inside inline-handler JS string literals: percent-encode,
   INCLUDING the characters encodeURIComponent leaves alone that could
   terminate a single-quoted literal or call a function — ' ( ) ! * —
   (the HTML parser entity-decodes attribute values BEFORE the JS
   engine sees them, so esc() alone is not enough there); handlers
   decode via arg(). A CSI volume id is attacker-controlled free text,
   so this is a stored-XSS boundary, not cosmetics. */
function jsArg(s) {
  return encodeURIComponent(String(s ?? "")).replace(/[!'()*]/g,
    (c) => "%" + c.charCodeAt(0).toString(16).padStart(2, "0"));
}
/* fs path -> hash-route segment: encode everything except the
   directory separators the router splits on */
function hashPath(p) { return encodeURIComponent(p).replace(/%2F/g, "/"); }
function arg(s) { return decodeURIComponent(s); }
function shortId(id) { return esc(String(id || "").slice(0, 8)); }
function fmtTime(ns) {
  if (!ns) return "—";
  return new Date(ns / 1e6).toLocaleString();
}
function fmtMB(mb) { return mb >= 1024 ? (mb / 1024).toFixed(1) + " GiB" : mb + " MiB"; }

/* status → {class, label}; icon dot + text so state never rides color alone */
const STATUS = {
  running: "good", ready: "good", complete: "good", successful: "good",
  alive: "good", healthy: "good", eligible: "good",
  pending: "warning", initializing: "warning", starting: "warning",
  queued: "warning", paused: "warning", ineligible: "warning",
  blocked: "serious", draining: "serious", unknown: "serious", lost: "serious",
  cancelled: "serious", canceled: "serious",
  failed: "critical", down: "critical", dead: "neutral", stopped: "neutral",
  "left": "neutral",
};
function badge(status) {
  const cls = STATUS[String(status || "").toLowerCase()] || "neutral";
  return `<span class="badge ${cls}"><span class="dot"></span>${esc(status || "—")}</span>`;
}
function render(html) { $view.innerHTML = html; }
function renderError(e) {
  $view.innerHTML += `<div class="error-banner">request failed: ${esc(e.message || e)}</div>`;
}

/* every list view re-fetches on an interval; navigation cancels it */
function autoRefresh(fn, ms = 4000) {
  clearInterval(refreshTimer);
  refreshTimer = setInterval(() => fn().catch(() => {}), ms);
}

/* ---------- view contract ----------
The machine-checked route -> endpoint -> field manifest. The Python
harness (ui/harness.py) extracts this JSON and (a) walks every
declared field path against the REAL seeded API — a field the API
does not return fails the suite — and (b) cross-checks that every
PascalCase member access in each view function below is declared
here (API fields are PascalCase, JS locals are camelCase), so a view
cannot silently read an undeclared — and therefore unwalked — field.
Path DSL: "." descends; leading "[]" = response is a list (check the
first element); "KEY[]" = list-valued field; "*" = every dict value;
a "?" prefix marks a field the API may legitimately omit.
__VIEW_CONTRACT_START__
{
  "viewOverview": {"endpoints": {"jobs": "/v1/jobs", "nodes": "/v1/nodes", "allocs": "/v1/allocations", "evals": "/v1/evaluations", "leader": "/v1/status/leader"},
    "uses": ["evalTable"],
    "walk": {"jobs": ["[].Status"], "nodes": ["[].Status"], "allocs": ["[].ClientStatus"], "evals": ["@evalTable"]}},
  "viewJobs": {"endpoints": {"jobs": "/v1/jobs"},
    "walk": {"jobs": ["[].ID", "[].Name", "[].Priority", "[].Status", "[].Stop", "[].Type", "[].Version"]}},
  "viewJobDetail": {"endpoints": {"job": "/v1/job/{job}", "summary": "/v1/job/{job}/summary", "allocs": "/v1/job/{job}/allocations", "evals": "/v1/job/{job}/evaluations", "deploys": "/v1/job/{job}/deployments", "versions": "/v1/job/{job}/versions"},
    "uses": ["allocTable", "evalTable", "deployTable", "versionsTable"],
    "walk": {"job": ["ID", "Name", "Type", "Priority", "Status", "Stop", "Version", "Datacenters", "TaskGroups[].Name", "TaskGroups[].Count"],
             "summary": ["Summary.*.Queued", "Summary.*.Starting", "Summary.*.Running", "Summary.*.Failed", "Summary.*.Complete", "Summary.*.Lost"],
             "allocs": ["@allocTable"], "evals": ["@evalTable"], "deploys": ["@deployTable"],
             "versions": ["Versions[].Version", "Versions[].Stable", "Versions[].Stop", "Versions[].Status"]}},
  "viewClients": {"endpoints": {"nodes": "/v1/nodes"},
    "walk": {"nodes": ["[].ID", "[].Name", "[].Datacenter", "?[].NodeClass", "?[].NodePool", "[].Status", "[].SchedulingEligibility", "[].Drain"]}},
  "viewClientDetail": {"endpoints": {"node": "/v1/node/{node}", "allocs": "/v1/node/{node}/allocations"},
    "uses": ["allocTable"],
    "walk": {"node": ["ID", "Name", "Datacenter", "?NodePool", "Status", "SchedulingEligibility", "Drain", "NodeResources.CPU.CPUShares", "NodeResources.Memory.MemoryMB", "NodeResources.Disk.DiskMB", "Attributes", "Drivers.*.Detected", "Drivers.*.Healthy"],
             "allocs": ["@allocTable"]}},
  "viewAllocs": {"endpoints": {"allocs": "/v1/allocations"},
    "walk": {"allocs": ["[].ID", "[].JobID", "[].TaskGroup", "[].NodeID", "?[].NodeName", "[].DesiredStatus", "[].ClientStatus", "[].ModifyTime"]}},
  "viewAllocDetail": {"endpoints": {"alloc": "/v1/allocation/{alloc}"},
    "uses": ["placementMetrics"],
    "walk": {"alloc": ["ID", "Name", "JobID", "NodeID", "?NodeName", "ClientStatus", "DesiredStatus", "TaskGroup", "?EvalID", "?DeploymentID", "?CreateTime", "?CreateTimeNs", "TaskStates.*.State", "TaskStates.*.Events[].Type", "?TaskStates.*.Events[].Time", "?TaskStates.*.Events[].TimeNs", "?TaskStates.*.Events[].DisplayMessage", "?TaskStates.*.Events[].Message", "Metrics.NodesEvaluated", "Metrics.NodesFiltered", "Metrics.NodesExhausted", "?Metrics.ScoreMeta"]}},
  "viewEvals": {"endpoints": {"evals": "/v1/evaluations"}, "uses": ["evalTable"],
    "walk": {"evals": ["@evalTable"]}},
  "viewDeployments": {"endpoints": {"deploys": "/v1/deployments"}, "uses": ["deployTable"],
    "walk": {"deploys": ["@deployTable"]}},
  "viewServices": {"endpoints": {"groups": "/v1/services", "insts": "/v1/service/{service}"},
    "walk": {"groups": ["[].Namespace", "[].Services[].ServiceName", "?[].Services[].Tags"],
             "insts": ["[].ID", "?[].AllocID", "[].NodeID", "?[].Address", "?[].Port"]}},
  "viewVolumes": {"endpoints": {"vols": "/v1/volumes", "plugins": "/v1/plugins"},
    "walk": {"vols": ["[].ID", "?[].Name", "[].PluginID", "[].Schedulable", "?[].AccessMode", "?[].CurrentReaders", "?[].CurrentWriters"],
             "plugins": ["[].ID", "?[].Provider", "?[].ControllersHealthy", "?[].ControllersExpected", "?[].NodesHealthy", "?[].NodesExpected"]}},
  "viewVolumeDetail": {"endpoints": {"vol": "/v1/volume/csi/{volume}"},
    "walk": {"vol": ["ID", "?Name", "?Namespace", "PluginID", "Schedulable", "?AccessMode", "?AttachmentMode", "?CurrentReaders", "?CurrentWriters", "?ReadAllocs[].ID", "?ReadAllocs[].ClientStatus", "?WriteAllocs[].ID", "?WriteAllocs[].ClientStatus"]}},
  "viewPluginDetail": {"endpoints": {"plugin": "/v1/plugin/csi/{plugin}"},
    "walk": {"plugin": ["ID", "?Provider", "?Version", "?ControllersHealthy", "?ControllersExpected", "?NodesHealthy", "?NodesExpected"]}},
  "viewACL": {"endpoints": {"policies": "/v1/acl/policies", "tokens": "/v1/acl/tokens"},
    "walk": {"policies": ["[].Name", "?[].Description"],
             "tokens": ["[].Name", "[].Type", "[].AccessorID", "?[].Policies", "?[].Global"]}},
  "viewACLPolicy": {"endpoints": {"policy": "/v1/acl/policy/{policy}"},
    "walk": {"policy": ["Name", "?Description", "Rules"]}},
  "viewTopology": {"endpoints": {"nodes": "/v1/nodes?resources=true", "allocs": "/v1/allocations?resources=true"},
    "walk": {"nodes": ["[].ID", "[].Name", "[].Datacenter", "[].Status", "[].Drain", "[].NodeResources.CPU", "[].NodeResources.MemoryMB"],
             "allocs": ["[].ClientStatus", "[].NodeID", "[].AllocatedResources.CPU", "[].AllocatedResources.MemoryMB"]}},
  "viewServers": {"endpoints": {"members": "/v1/agent/members", "raft": "/v1/operator/raft/configuration", "health": "/v1/operator/autopilot/health"},
    "walk": {"members": ["ServerRegion", "Members[].Name", "Members[].Addr", "Members[].Status", "?Members[].Tags"],
             "raft": ["Servers[].ID", "Servers[].Address", "Servers[].Leader", "Servers[].Voter"],
             "health": ["Healthy", "FailureTolerance"]}},
  "viewSettings": {"endpoints": {"self": "/v1/agent/self"}, "walk": {"self": []}},
  "viewAllocFs": {"endpoints": {"ls": "/v1/client/fs/ls/{alloc}?path=/"},
    "walk": {"ls": ["[].Name", "[].IsDir", "[].Size", "[].ModTime"]}},
  "viewAllocFile": {"endpoints": {"stat": "/v1/client/fs/stat/{alloc}?path={file}", "read": "/v1/client/fs/readat/{alloc}?path={file}&offset=0&limit=64"},
    "walk": {"stat": ["Size", "Name", "IsDir", "ModTime"], "read": ["Data"]}},
  "viewAllocLogs": {"endpoints": {"logs": "/v1/client/fs/logs/{alloc}?task={task}&type=stdout"},
    "walk": {"logs": ["Data"]}},
  "helpers": {
    "allocTable": ["[].ID", "[].TaskGroup", "[].NodeID", "?[].NodeName", "[].DesiredStatus", "[].ClientStatus", "?[].CreateTime", "?[].CreateTimeNs"],
    "evalTable": ["[].ID", "[].JobID", "[].Type", "[].TriggeredBy", "[].Status", "?[].StatusDescription"],
    "deployTable": ["[].ID", "[].JobID", "[].Status", "?[].StatusDescription"],
    "versionsTable": ["[].Version", "[].Stable", "[].Stop", "[].Status"],
    "placementMetrics": ["NodesEvaluated", "NodesFiltered", "NodesExhausted", "?ScoreMeta"]
  }
}
__VIEW_CONTRACT_END__ */

/* ---------- views ---------- */

async function viewOverview() {
  const [jobs, nodes, allocs, evals, leader] = await Promise.all([
    get("/v1/jobs"), get("/v1/nodes"), get("/v1/allocations"),
    get("/v1/evaluations"), get("/v1/status/leader").catch(() => "n/a"),
  ]);
  const count = (xs, f) => xs.filter(f).length;
  render(`
    <h1>Cluster overview</h1>
    <p class="sub">leader: <code>${esc(leader)}</code></p>
    <div class="tiles">
      <div class="tile"><div class="v">${jobs.length}</div><div class="k">jobs</div></div>
      <div class="tile"><div class="v">${count(jobs, j => j.Status === "running")}</div><div class="k">jobs running</div></div>
      <div class="tile"><div class="v">${nodes.length}</div><div class="k">clients</div></div>
      <div class="tile"><div class="v">${count(nodes, n => n.Status === "ready")}</div><div class="k">clients ready</div></div>
      <div class="tile"><div class="v">${count(allocs, a => a.ClientStatus === "running")}</div><div class="k">allocs running</div></div>
      <div class="tile"><div class="v">${count(allocs, a => a.ClientStatus === "failed")}</div><div class="k">allocs failed</div></div>
      <div class="tile"><div class="v">${count(evals, e => e.Status === "pending" || e.Status === "blocked")}</div><div class="k">evals queued</div></div>
    </div>
    <h2>Recent evaluations</h2>
    ${evalTable(evals.slice(-8).reverse())}
  `);
}

async function viewJobs() {
  const jobs = await get("/v1/jobs");
  render(`
    <div class="toolbar"><div><h1>Jobs</h1>
    <p class="sub">${jobs.length} job(s) in namespace ${esc(localStorage.getItem("nomad_namespace") || "default")}</p></div></div>
    <table><thead><tr><th>Name</th><th>Type</th><th>Priority</th><th>Status</th><th>Version</th></tr></thead><tbody>
    ${jobs.map(j => `<tr class="rowlink" onclick="location.hash='#/jobs/${encodeURIComponent(j.ID)}'">
      <td><a href="#/jobs/${encodeURIComponent(j.ID)}">${esc(j.Name)}</a><br><span class="muted mono">${esc(j.ID)}</span></td>
      <td>${esc(j.Type)}</td><td>${j.Priority}</td><td>${badge(j.Stop ? "stopped" : j.Status)}</td>
      <td>v${j.Version}</td></tr>`).join("")}
    </tbody></table>`);
}

async function viewJobDetail(id) {
  const [job, summary, allocs, evals, deploys, vresp] = await Promise.all([
    get(`/v1/job/${encodeURIComponent(id)}`),
    get(`/v1/job/${encodeURIComponent(id)}/summary`).catch(() => null),
    get(`/v1/job/${encodeURIComponent(id)}/allocations`).catch(() => []),
    get(`/v1/job/${encodeURIComponent(id)}/evaluations`).catch(() => []),
    get(`/v1/job/${encodeURIComponent(id)}/deployments`).catch(() => []),
    get(`/v1/job/${encodeURIComponent(id)}/versions`).catch(() => null),
  ]);
  const versions = (vresp && vresp.Versions) || [];
  const sum = (summary && summary.Summary) || {};
  render(`
    <h1>${esc(job.Name)} ${badge(job.Stop ? "stopped" : job.Status)}</h1>
    <p class="sub mono">${esc(job.ID)} · ${esc(job.Type)} · priority ${job.Priority} · v${job.Version} · dc [${(job.Datacenters || []).map(esc).join(", ")}]</p>
    <div class="actions">
      <button onclick="jobAction('stop','${jsArg(id)}')" class="danger">Stop job</button>
      <button onclick="jobAction('purge','${jsArg(id)}')" class="danger">Purge</button>
    </div>
    <h2>Task groups</h2>
    <table><thead><tr><th>Group</th><th>Count</th><th>Queued</th><th>Starting</th><th>Running</th><th>Failed</th><th>Complete</th><th>Lost</th><th>Scale</th></tr></thead><tbody>
    ${(job.TaskGroups || []).map(tg => {
      const s = sum[tg.Name] || {};
      return `<tr><td>${esc(tg.Name)}</td><td>${tg.Count}</td>
        <td>${s.Queued ?? 0}</td><td>${s.Starting ?? 0}</td><td>${s.Running ?? 0}</td>
        <td>${s.Failed ?? 0}</td><td>${s.Complete ?? 0}</td><td>${s.Lost ?? 0}</td>
        <td><button onclick="scaleGroup('${jsArg(id)}','${jsArg(tg.Name)}',${(tg.Count | 0) - 1})">−</button>
            <button onclick="scaleGroup('${jsArg(id)}','${jsArg(tg.Name)}',${(tg.Count | 0) + 1})">+</button></td></tr>`;
    }).join("")}
    </tbody></table>
    <h2>Allocations (${allocs.length})</h2>
    ${allocTable(allocs)}
    <h2>Deployments</h2>
    ${deployTable(deploys)}
    <h2>Versions</h2>
    ${versionsTable(id, versions, job.Version)}
    <h2>Evaluations</h2>
    ${evalTable(evals.slice(-10).reverse())}
  `);
}

function versionsTable(jobId, versions, current) {
  if (!versions || !versions.length) return `<p class="muted">none</p>`;
  return `<table><thead><tr><th>Version</th><th>Stable</th><th>Status</th><th></th></tr></thead><tbody>
  ${versions.map(v => `<tr>
    <td>v${v.Version}${v.Version === current ? ' <span class="muted">(current)</span>' : ""}</td>
    <td>${v.Stable ? "yes" : ""}</td>
    <td>${badge(v.Stop ? "stopped" : v.Status)}</td>
    <td>${v.Version === current ? "" :
      `<button onclick="jobRevert('${jsArg(jobId)}',${v.Version | 0})">Revert to</button>`}</td>
  </tr>`).join("")}</tbody></table>`;
}

window.jobRevert = async (id, version) => {
  id = arg(id);
  if (!confirm(`revert ${id} to version ${version}?`)) return;
  try {
    await post(`/v1/job/${encodeURIComponent(id)}/revert`,
               { JobID: id, JobVersion: version });
    route();
  } catch (e) { renderError(e); }
};

window.jobAction = async (verb, id) => {
  id = arg(id);
  if (!confirm(`${verb} job ${id}?`)) return;
  try {
    await del(`/v1/job/${encodeURIComponent(id)}` + (verb === "purge" ? "?purge=true" : ""));
    route();
  } catch (e) { renderError(e); }
};
window.scaleGroup = async (id, group, count) => {
  id = arg(id); group = arg(group);
  if (count < 0) return;
  try {
    await post(`/v1/job/${encodeURIComponent(id)}/scale`,
      { Target: { Group: group }, Count: count, Message: "scaled from web UI" });
    route();
  } catch (e) { renderError(e); }
};

function allocTable(allocs) {
  if (!allocs.length) return `<p class="muted">none</p>`;
  return `<table><thead><tr><th>ID</th><th>Task group</th><th>Node</th><th>Desired</th><th>Client status</th><th>Created</th></tr></thead><tbody>
  ${allocs.map(a => `<tr class="rowlink" onclick="location.hash='#/allocations/${jsArg(a.ID)}'">
    <td class="mono"><a href="#/allocations/${jsArg(a.ID)}">${shortId(a.ID)}</a></td>
    <td>${esc(a.TaskGroup)}</td>
    <td class="mono"><a href="#/clients/${jsArg(a.NodeID)}" onclick="event.stopPropagation()">${esc(a.NodeName || shortId(a.NodeID))}</a></td>
    <td>${badge(a.DesiredStatus)}</td><td>${badge(a.ClientStatus)}</td>
    <td class="muted">${fmtTime(a.CreateTime || a.CreateTimeNs)}</td></tr>`).join("")}
  </tbody></table>`;
}
function evalTable(evals) {
  if (!evals.length) return `<p class="muted">none</p>`;
  return `<table><thead><tr><th>ID</th><th>Job</th><th>Type</th><th>Triggered by</th><th>Status</th></tr></thead><tbody>
  ${evals.map(e => `<tr>
    <td class="mono">${shortId(e.ID)}</td>
    <td class="mono"><a href="#/jobs/${encodeURIComponent(e.JobID)}">${esc(e.JobID || "—")}</a></td>
    <td>${esc(e.Type)}</td><td>${esc(e.TriggeredBy)}</td>
    <td>${badge(e.Status)}${e.StatusDescription ? ` <span class="muted">${esc(e.StatusDescription)}</span>` : ""}</td></tr>`).join("")}
  </tbody></table>`;
}
function deployTable(ds) {
  if (!ds || !ds.length) return `<p class="muted">none</p>`;
  return `<table><thead><tr><th>ID</th><th>Job</th><th>Status</th><th>Description</th><th></th></tr></thead><tbody>
  ${ds.map(d => `<tr>
    <td class="mono">${shortId(d.ID)}</td>
    <td class="mono"><a href="#/jobs/${encodeURIComponent(d.JobID || "")}">${esc(d.JobID || "—")}</a></td>
    <td>${badge(d.Status)}</td><td class="muted">${esc(d.StatusDescription || "")}</td>
    <td>${d.Status === "running" ? `
      <button onclick="deployAction('promote','${jsArg(d.ID)}')">Promote</button>
      <button onclick="deployAction('fail','${jsArg(d.ID)}')" class="danger">Fail</button>` : ""}</td></tr>`).join("")}
  </tbody></table>`;
}
window.deployAction = async (verb, id) => {
  try {
    await post(`/v1/deployment/${verb}/${id}`, verb === "promote" ? { All: true } : {});
    route();
  } catch (e) { renderError(e); }
};

async function viewClients() {
  const nodes = await get("/v1/nodes");
  render(`
    <h1>Clients</h1>
    <p class="sub">${nodes.length} node(s)</p>
    <table><thead><tr><th>Name</th><th>Datacenter</th><th>Class</th><th>Pool</th><th>Status</th><th>Eligibility</th><th>Drain</th></tr></thead><tbody>
    ${nodes.map(n => `<tr class="rowlink" onclick="location.hash='#/clients/${jsArg(n.ID)}'">
      <td><a href="#/clients/${jsArg(n.ID)}">${esc(n.Name)}</a><br><span class="muted mono">${shortId(n.ID)}</span></td>
      <td>${esc(n.Datacenter)}</td><td>${esc(n.NodeClass || "—")}</td><td>${esc(n.NodePool || "default")}</td>
      <td>${badge(n.Status)}</td><td>${badge(n.SchedulingEligibility)}</td>
      <td>${n.Drain ? badge("draining") : '<span class="muted">—</span>'}</td></tr>`).join("")}
    </tbody></table>`);
}

async function viewClientDetail(id) {
  const [node, allocs] = await Promise.all([
    get(`/v1/node/${id}`), get(`/v1/node/${id}/allocations`).catch(() => []),
  ]);
  const nr = node.NodeResources || {};
  const cpu = (nr.CPU || {}).CPUShares || 0;
  const mem = (nr.Memory || {}).MemoryMB || 0;
  const disk = (nr.Disk || {}).DiskMB || 0;
  const attrs = node.Attributes || {};
  const drivers = node.Drivers || {};
  const eligible = node.SchedulingEligibility === "eligible";
  render(`
    <h1>${esc(node.Name)} ${badge(node.Status)}</h1>
    <p class="sub mono">${esc(node.ID)} · ${esc(node.Datacenter)} · pool ${esc(node.NodePool || "default")}</p>
    <div class="actions">
      <button onclick="nodeDrain('${jsArg(node.ID)}', ${node.Drain ? "false" : "true"})" ${node.Drain ? "" : 'class="danger"'}>
        ${node.Drain ? "Stop drain" : "Drain node"}</button>
      <button onclick="nodeElig('${jsArg(node.ID)}', '${eligible ? "ineligible" : "eligible"}')">
        Mark ${eligible ? "ineligible" : "eligible"}</button>
    </div>
    <div class="tiles">
      <div class="tile"><div class="v">${cpu}</div><div class="k">CPU MHz</div></div>
      <div class="tile"><div class="v">${fmtMB(mem)}</div><div class="k">memory</div></div>
      <div class="tile"><div class="v">${fmtMB(disk)}</div><div class="k">disk</div></div>
      <div class="tile"><div class="v">${allocs.length}</div><div class="k">allocations</div></div>
    </div>
    <h2>Drivers</h2>
    <table><thead><tr><th>Driver</th><th>Detected</th><th>Healthy</th></tr></thead><tbody>
      ${Object.entries(drivers).map(([name, d]) => `<tr><td>${esc(name)}</td>
        <td>${d.Detected ? "yes" : "no"}</td><td>${badge(d.Healthy ? "healthy" : "unhealthy")}</td></tr>`).join("")}
    </tbody></table>
    <h2>Allocations</h2>
    ${allocTable(allocs.map(a => ({ ...a, ID: a.ID || a.id, NodeID: id })))}
    <h2>Attributes</h2>
    <dl class="kv">${Object.entries(attrs).sort().map(([k, v]) =>
      `<dt class="mono">${esc(k)}</dt><dd class="mono">${esc(v)}</dd>`).join("")}</dl>
  `);
}
window.nodeDrain = async (id, enable) => {
  try {
    await post(`/v1/node/${id}/drain`,
      enable === "true" || enable === true ? { DrainSpec: { Deadline: 3600e9 } } : { DrainSpec: null });
    route();
  } catch (e) { renderError(e); }
};
window.nodeElig = async (id, elig) => {
  try { await post(`/v1/node/${id}/eligibility`, { Eligibility: elig }); route(); }
  catch (e) { renderError(e); }
};

async function viewAllocs() {
  const allocs = await get("/v1/allocations");
  render(`
    <h1>Allocations</h1>
    <p class="sub">${allocs.length} allocation(s)</p>
    <table><thead><tr><th>ID</th><th>Job</th><th>Task group</th><th>Node</th><th>Desired</th><th>Client status</th><th>Modified</th></tr></thead><tbody>
    ${allocs.map(a => `<tr class="rowlink" onclick="location.hash='#/allocations/${jsArg(a.ID)}'">
      <td class="mono"><a href="#/allocations/${jsArg(a.ID)}">${shortId(a.ID)}</a></td>
      <td class="mono"><a href="#/jobs/${encodeURIComponent(a.JobID)}" onclick="event.stopPropagation()">${esc(a.JobID)}</a></td>
      <td>${esc(a.TaskGroup)}</td>
      <td>${esc(a.NodeName || shortId(a.NodeID))}</td>
      <td>${badge(a.DesiredStatus)}</td><td>${badge(a.ClientStatus)}</td>
      <td class="muted">${fmtTime(a.ModifyTime)}</td></tr>`).join("")}
    </tbody></table>`);
}

async function viewAllocDetail(id) {
  const a = await get(`/v1/allocation/${id}`);
  const states = a.TaskStates || {};
  render(`
    <h1>Allocation ${shortId(a.ID)} ${badge(a.ClientStatus)}</h1>
    <p class="sub mono">${esc(a.Name || a.ID)} · job <a href="#/jobs/${encodeURIComponent(a.JobID)}">${esc(a.JobID)}</a>
      · node <a href="#/clients/${jsArg(a.NodeID)}">${esc(a.NodeName || shortId(a.NodeID))}</a></p>
    <div class="actions">
      <a href="#/allocations/${jsArg(a.ID)}/fs"><button>Files</button></a>
      <button onclick="allocStop('${jsArg(a.ID)}')" class="danger">Stop allocation</button>
    </div>
    <dl class="kv">
      <dt>Desired status</dt><dd>${badge(a.DesiredStatus)}</dd>
      <dt>Task group</dt><dd>${esc(a.TaskGroup)}</dd>
      <dt>Eval</dt><dd class="mono">${esc(a.EvalID || "—")}</dd>
      <dt>Deployment</dt><dd class="mono">${esc(a.DeploymentID || "—")}</dd>
      <dt>Created</dt><dd>${fmtTime(a.CreateTime || a.CreateTimeNs)}</dd>
    </dl>
    <h2>Tasks</h2>
    ${Object.keys(states).length ? Object.entries(states).map(([name, st]) => `
      <h2 class="mono" style="font-size:13.5px">${esc(name)} ${badge(st.State)}
        <a href="#/allocations/${jsArg(a.ID)}/logs/${jsArg(name)}"><button>Logs</button></a>
        ${st.State === "running" ? `<a href="#/allocations/${jsArg(a.ID)}/exec/${jsArg(name)}"><button>Exec</button></a>` : ""}
      </h2>
      <table><thead><tr><th>Time</th><th>Type</th><th>Message</th></tr></thead><tbody>
      ${(st.Events || []).map(ev => `<tr>
        <td class="muted">${fmtTime(ev.Time || ev.TimeNs)}</td><td>${esc(ev.Type)}</td>
        <td>${esc(ev.DisplayMessage || ev.Message || "")}</td></tr>`).join("")}
      </tbody></table>`).join("") : `<p class="muted">no task state reported yet</p>`}
    <h2>Placement metrics</h2>
    ${placementMetrics(a.Metrics)}
  `);
}
function placementMetrics(m) {
  if (!m) return `<p class="muted">none</p>`;
  /* ScoreMeta entries are [nodeID, {score-name: value}, normScore]
     (AllocMetric top-K node scores via kheap) */
  const scores = m.ScoreMeta || [];
  return `<dl class="kv">
    <dt>Nodes evaluated</dt><dd>${m.NodesEvaluated ?? "—"}</dd>
    <dt>Nodes filtered</dt><dd>${m.NodesFiltered ?? "—"}</dd>
    <dt>Nodes exhausted</dt><dd>${m.NodesExhausted ?? "—"}</dd>
  </dl>
  ${scores.length ? `<table><thead><tr><th>Node</th><th>Norm score</th><th>Scores</th></tr></thead><tbody>
    ${scores.slice(0, 8).map(([nodeId, byName, norm]) => `<tr><td class="mono">${shortId(nodeId)}</td>
      <td>${(+norm || 0).toFixed(4)}</td>
      <td class="muted">${esc(Object.entries(byName || {}).map(([k, v]) => `${k}=${(+v).toFixed(3)}`).join(" "))}</td>
    </tr>`).join("")}</tbody></table>` : ""}`;
}
window.allocStop = async (id) => {
  if (!confirm(`stop allocation ${id.slice(0, 8)}?`)) return;
  try { await post(`/v1/allocation/${id}/stop`); route(); }
  catch (e) { renderError(e); }
};

async function viewEvals() {
  const evals = await get("/v1/evaluations");
  render(`<h1>Evaluations</h1>
    <p class="sub">${evals.length} evaluation(s)</p>
    ${evalTable(evals.slice().reverse())}`);
}

async function viewDeployments() {
  const ds = await get("/v1/deployments");
  render(`<h1>Deployments</h1>
    <p class="sub">${ds.length} deployment(s)</p>
    ${deployTable(ds.slice().reverse())}`);
}

async function viewServices() {
  const groups = await get("/v1/services");
  const specs = [];
  for (const g of groups) {
    for (const svc of (g.Services || [])) {
      specs.push({ ns: g.Namespace, name: svc.ServiceName,
                   tags: svc.Tags || [] });
    }
  }
  // one parallel fetch per service, pinned to the group's namespace
  // (the list can span namespaces; instance lookup is exact-match)
  const rows = await Promise.all(specs.map(async (spec) => ({
    ...spec,
    insts: await get(
      `/v1/service/${encodeURIComponent(spec.name)}` +
      `?namespace=${encodeURIComponent(spec.ns)}`).catch(() => []),
  })));
  render(`
    <h1>Services</h1>
    <p class="sub">${rows.length} service(s) (native service discovery)</p>
    ${rows.length ? rows.map(r => `
      <h2>${esc(r.name)} <span class="muted">${esc(r.tags.join(", "))}</span></h2>
      <table><thead><tr><th>ID</th><th>Alloc</th><th>Node</th><th>Address</th><th>Port</th></tr></thead><tbody>
      ${(r.insts || []).map(i => `<tr>
        <td class="mono">${shortId(i.ID)}</td>
        <td class="mono">${i.AllocID
          ? `<a href="#/allocations/${jsArg(i.AllocID)}">${shortId(i.AllocID)}</a>`
          : '<span class="muted">—</span>'}</td>
        <td class="mono">${shortId(i.NodeID)}</td>
        <td class="mono">${esc(i.Address || "")}</td><td>${i.Port ?? ""}</td></tr>`).join("")}
      </tbody></table>`).join("") : `<p class="muted">no registered services</p>`}
  `);
}

async function viewVolumes() {
  const [vols, plugins] = await Promise.all([
    get("/v1/volumes").catch(() => []),
    get("/v1/plugins").catch(() => []),
  ]);
  render(`
    <h1>Volumes</h1>
    <p class="sub">${vols.length} CSI volume(s)</p>
    ${vols.length ? `<table><thead><tr><th>ID</th><th>Name</th><th>Plugin</th><th>Schedulable</th><th>Access</th><th>Allocs</th></tr></thead><tbody>
    ${vols.map(v => `<tr class="rowlink" onclick="location.hash='#/volumes/${jsArg(v.ID)}'">
      <td class="mono"><a href="#/volumes/${jsArg(v.ID)}">${esc(v.ID)}</a></td><td>${esc(v.Name || "")}</td>
      <td class="mono"><a href="#/plugins/${jsArg(v.PluginID || "")}">${esc(v.PluginID || "")}</a></td>
      <td>${badge(v.Schedulable ? "ready" : "unavailable")}</td>
      <td class="muted">${esc(v.AccessMode || "")}</td>
      <td>${(v.CurrentReaders ?? 0) + (v.CurrentWriters ?? 0)}</td></tr>`).join("")}
    </tbody></table>` : `<p class="muted">none</p>`}
    <h2>Plugins</h2>
    ${plugins.length ? `<table><thead><tr><th>ID</th><th>Provider</th><th>Controllers</th><th>Nodes</th></tr></thead><tbody>
    ${plugins.map(p => `<tr class="rowlink" onclick="location.hash='#/plugins/${jsArg(p.ID)}'">
      <td class="mono"><a href="#/plugins/${jsArg(p.ID)}">${esc(p.ID)}</a></td><td>${esc(p.Provider || "")}</td>
      <td>${p.ControllersHealthy ?? 0}/${p.ControllersExpected ?? 0}</td>
      <td>${p.NodesHealthy ?? 0}/${p.NodesExpected ?? 0}</td></tr>`).join("")}
    </tbody></table>` : `<p class="muted">none</p>`}
  `);
}

async function viewVolumeDetail(id) {
  const v = await get(`/v1/volume/csi/${encodeURIComponent(id)}`);
  const allocRow = (a, mode) => `<tr class="rowlink"
      onclick="location.hash='#/allocations/${jsArg(a.ID)}'">
    <td class="mono"><a href="#/allocations/${jsArg(a.ID)}">${shortId(a.ID)}</a></td>
    <td>${esc(mode)}</td><td>${badge(a.ClientStatus)}</td></tr>`;
  render(`
    <h1>${esc(v.Name || v.ID)}</h1>
    <p class="sub mono">${esc(v.ID)}</p>
    <div class="tiles">
      <div class="tile"><div class="v">${badge(v.Schedulable ? "ready" : "unavailable")}</div><div class="k">schedulable</div></div>
      <div class="tile"><div class="v">${esc(v.AccessMode || "—")}</div><div class="k">access mode</div></div>
      <div class="tile"><div class="v">${esc(v.AttachmentMode || "—")}</div><div class="k">attachment</div></div>
      <div class="tile"><div class="v">${(v.CurrentReaders ?? 0)}/${(v.CurrentWriters ?? 0)}</div><div class="k">readers/writers</div></div>
    </div>
    <p class="sub">plugin <a class="mono" href="#/plugins/${jsArg(v.PluginID || "")}">${esc(v.PluginID || "—")}</a>
       · namespace ${esc(v.Namespace || "default")}</p>
    <h2>Claims</h2>
    <table><thead><tr><th>Alloc</th><th>Mode</th><th>Status</th></tr></thead><tbody>
      ${(v.ReadAllocs || []).map(a => allocRow(a, "read")).join("")}
      ${(v.WriteAllocs || []).map(a => allocRow(a, "write")).join("")}
    </tbody></table>
    <button class="danger" onclick="detachVolume('${jsArg(v.ID)}')">Detach all</button>
  `);
}
async function detachVolume(id) {
  try {
    await post(`/v1/volume/csi/${encodeURIComponent(arg(id))}/detach`, {});
    route();
  } catch (e) { renderError(e); }
}

async function viewPluginDetail(id) {
  const p = await get(`/v1/plugin/csi/${encodeURIComponent(id)}`);
  render(`
    <h1>Plugin ${esc(p.ID)}</h1>
    <p class="sub">provider ${esc(p.Provider || "—")} ${esc(p.Version || "")}</p>
    <div class="tiles">
      <div class="tile"><div class="v">${p.ControllersHealthy ?? 0}/${p.ControllersExpected ?? 0}</div><div class="k">controllers healthy</div></div>
      <div class="tile"><div class="v">${p.NodesHealthy ?? 0}/${p.NodesExpected ?? 0}</div><div class="k">nodes healthy</div></div>
    </div>
  `);
}

/* ---------- ACL management (reference ui/ policies + tokens) ---------- */

async function viewACL() {
  const [policies, tokens] = await Promise.all([
    get("/v1/acl/policies").catch(() => []),
    get("/v1/acl/tokens").catch(() => []),
  ]);
  render(`
    <div class="toolbar"><div><h1>Access control</h1>
    <p class="sub">${policies.length} policy(ies), ${tokens.length} token(s)</p></div>
    <button onclick="location.hash='#/acl/policies/_new'">New policy</button></div>
    <h2>Policies</h2>
    ${policies.length ? `<table><thead><tr><th>Name</th><th>Description</th></tr></thead><tbody>
    ${policies.map(p => `<tr class="rowlink" onclick="location.hash='#/acl/policies/${jsArg(p.Name)}'">
      <td><a href="#/acl/policies/${jsArg(p.Name)}">${esc(p.Name)}</a></td>
      <td class="muted">${esc(p.Description || "")}</td></tr>`).join("")}
    </tbody></table>` : `<p class="muted">no policies (ACLs may be disabled)</p>`}
    <h2>Tokens</h2>
    ${tokens.length ? `<table><thead><tr><th>Name</th><th>Type</th><th>Accessor</th><th>Policies</th><th>Global</th></tr></thead><tbody>
    ${tokens.map(t => `<tr>
      <td>${esc(t.Name || "")}</td><td>${esc(t.Type)}</td>
      <td class="mono">${shortId(t.AccessorID)}</td>
      <td class="mono">${esc((t.Policies || []).join(", "))}</td>
      <td>${t.Global ? "yes" : ""}</td></tr>`).join("")}
    </tbody></table>` : `<p class="muted">no tokens visible</p>`}
  `);
}

async function viewACLPolicy(name) {
  const fresh = name === "_new";
  let p = { Name: "", Description: "", Rules: "" };
  if (!fresh) p = await get(`/v1/acl/policy/${encodeURIComponent(name)}`);
  render(`
    <h1>${fresh ? "New policy" : `Policy ${esc(p.Name)}`}</h1>
    <div class="form">
      <label>Name <input id="pol-name" value="${esc(p.Name)}" ${fresh ? "" : "readonly"}></label>
      <label>Description <input id="pol-desc" value="${esc(p.Description || "")}"></label>
      <label>Rules (HCL)<textarea id="pol-rules" rows="14" class="mono">${esc(p.Rules || "")}</textarea></label>
      <div class="toolbar">
        <button onclick="savePolicy()">Save</button>
        ${fresh ? "" : `<button class="danger" onclick="deletePolicy('${jsArg(p.Name)}')">Delete</button>`}
      </div>
    </div>
  `);
}
async function savePolicy() {
  const name = document.getElementById("pol-name").value.trim();
  if (!name) { renderError(new Error("policy name required")); return; }
  try {
    await post(`/v1/acl/policy/${encodeURIComponent(name)}`, {
      Name: name,
      Description: document.getElementById("pol-desc").value,
      Rules: document.getElementById("pol-rules").value,
    });
    location.hash = "#/acl";
  } catch (e) { renderError(e); }
}
async function deletePolicy(name) {
  try {
    await del(`/v1/acl/policy/${encodeURIComponent(arg(name))}`);
    location.hash = "#/acl";
  } catch (e) { renderError(e); }
}

async function viewTopology() {
  // both stubs carry flattened resources (?resources=true) so the
  // whole view is two list calls regardless of cluster size
  const [nodes, allocs] = await Promise.all([
    get("/v1/nodes?resources=true"), get("/v1/allocations?resources=true"),
  ]);
  const byNode = {};
  for (const a of allocs) {
    if (a.ClientStatus !== "running" && a.ClientStatus !== "pending") continue;
    const r = a.AllocatedResources || {};
    const agg = byNode[a.NodeID] || (byNode[a.NodeID] = { cpu: 0, mem: 0, n: 0 });
    agg.cpu += r.CPU || 0; agg.mem += r.MemoryMB || 0; agg.n += 1;
  }
  /* topo-viz analog (ui/app/components/topo-viz): one cell per node,
     grouped by datacenter, area ∝ memory capacity, fill height =
     allocated memory share, fill hue = allocated cpu share; hover for
     exact numbers, click through to the client. Scales to thousands
     of nodes where per-node meter cards cannot. */
  const byDC = {};
  for (const n of nodes) (byDC[n.Datacenter] || (byDC[n.Datacenter] = [])).push(n);
  const maxMem = Math.max(1, ...nodes.map(n => (n.NodeResources || {}).MemoryMB || 0));
  const cell = (node) => {
    const nr = node.NodeResources || {};
    const used = byNode[node.ID] || { cpu: 0, mem: 0, n: 0 };
    const memPct = nr.MemoryMB ? Math.min(100, 100 * used.mem / nr.MemoryMB) : 0;
    const cpuPct = nr.CPU ? Math.min(100, 100 * used.cpu / nr.CPU) : 0;
    /* green (idle) -> amber -> red (cpu-saturated) */
    const hue = Math.round(120 - 1.2 * cpuPct);
    const side = Math.round(22 + 26 * Math.sqrt((nr.MemoryMB || 0) / maxMem));
    const down = node.Status !== "ready";
    const title = `${node.Name} · ${node.Status}${node.Drain ? " draining" : ""}
cpu ${used.cpu}/${nr.CPU || 0} MHz (${cpuPct.toFixed(0)}%)
mem ${fmtMB(used.mem)}/${fmtMB(nr.MemoryMB || 0)} (${memPct.toFixed(0)}%)
${used.n} alloc(s)`;
    return `<div class="topo-cell${down ? " down" : ""}" title="${esc(title)}"
      onclick="location.hash='#/clients/${jsArg(node.ID)}'"
      style="width:${side}px;height:${side}px">
      <div class="fill" style="height:${memPct.toFixed(0)}%;background:hsl(${hue},65%,45%)"></div>
      ${node.Drain ? '<div class="drainmark">◢</div>' : ""}
    </div>`;
  };
  render(`
    <h1>Topology</h1>
    <p class="sub">${nodes.length} node(s) · ${allocs.length} allocation(s) —
      cell area ∝ memory capacity, fill = allocated memory, color = allocated cpu
      (green idle → red saturated); hatched = down, ◢ = draining</p>
    <style>
      .topo-dc { margin: 14px 0; }
      .topo-grid { display: flex; flex-wrap: wrap; gap: 4px; align-items: flex-end; }
      .topo-cell { position: relative; border: 1px solid var(--border,#444);
        border-radius: 3px; overflow: hidden; cursor: pointer;
        background: var(--panel,#1a1a1a); }
      .topo-cell .fill { position: absolute; bottom: 0; left: 0; right: 0; }
      .topo-cell.down { background: repeating-linear-gradient(45deg,
        transparent, transparent 3px, rgba(255,80,80,.45) 3px,
        rgba(255,80,80,.45) 6px); }
      .topo-cell .drainmark { position: absolute; top: 0; right: 2px;
        font-size: 9px; color: #fff; text-shadow: 0 0 2px #000; }
    </style>
    ${Object.keys(byDC).sort().map(dc => `
      <div class="topo-dc">
        <h2>${esc(dc)} <span class="muted" style="font-size:12px">${byDC[dc].length} node(s)</span></h2>
        <div class="topo-grid">${byDC[dc].map(cell).join("")}</div>
      </div>`).join("")}`);
}

async function viewServers() {
  const [members, raft, health] = await Promise.all([
    get("/v1/agent/members").catch(() => ({ Members: [] })),
    get("/v1/operator/raft/configuration").catch(() => null),
    get("/v1/operator/autopilot/health").catch(() => null),
  ]);
  render(`
    <h1>Servers</h1>
    <p class="sub">region ${esc(members.ServerRegion || "—")}</p>
    <table><thead><tr><th>Name</th><th>Address</th><th>Status</th><th>Tags</th></tr></thead><tbody>
    ${(members.Members || []).map(m => `<tr>
      <td>${esc(m.Name)}</td><td class="mono">${esc(m.Addr)}</td><td>${badge(m.Status)}</td>
      <td class="muted mono">${esc(Object.entries(m.Tags || {}).map(([k, v]) => `${k}=${v}`).join(" "))}</td></tr>`).join("")}
    </tbody></table>
    ${raft && raft.Servers ? `<h2>Raft configuration</h2>
    <table><thead><tr><th>ID</th><th>Address</th><th>Leader</th><th>Voter</th></tr></thead><tbody>
    ${raft.Servers.map(s => `<tr><td class="mono">${esc(s.ID)}</td><td class="mono">${esc(s.Address)}</td>
      <td>${s.Leader ? "yes" : ""}</td><td>${s.Voter ? "yes" : ""}</td></tr>`).join("")}
    </tbody></table>` : ""}
    ${health ? `<h2>Autopilot</h2><dl class="kv">
      <dt>Healthy</dt><dd>${badge(health.Healthy ? "healthy" : "unhealthy")}</dd>
      <dt>Failure tolerance</dt><dd>${health.FailureTolerance ?? "—"}</dd></dl>` : ""}
  `);
}

async function viewSettings() {
  render(`
    <h1>Settings</h1>
    <h2>ACL token</h2>
    <p class="sub">sent as <code>X-Nomad-Token</code> on every request; stored in this browser only</p>
    <div class="actions">
      <input type="password" id="tok" placeholder="Secret ID" value="${esc(token())}">
      <button onclick="localStorage.setItem('nomad_token', document.getElementById('tok').value); route();">Save</button>
      <button onclick="localStorage.removeItem('nomad_token'); route();" class="danger">Clear</button>
    </div>
    <h2>Namespace</h2>
    <div class="actions">
      <input type="text" id="ns" placeholder="default" value="${esc(localStorage.getItem("nomad_namespace") || "")}">
      <button onclick="localStorage.setItem('nomad_namespace', document.getElementById('ns').value); route();">Save</button>
    </div>
    <h2>Agent</h2>
    <pre class="mono" id="agent-self" style="white-space:pre-wrap"></pre>
  `);
  try {
    const self = await get("/v1/agent/self");
    document.getElementById("agent-self").textContent = JSON.stringify(self, null, 2).slice(0, 4000);
  } catch (e) { /* agent info is best-effort */ }
}

/* ---------- alloc filesystem browser (ui fs-browser analog) -------- */

async function viewAllocFs(allocId, path) {
  path = path || "/";
  const entries = await get(
    `/v1/client/fs/ls/${jsArg(allocId)}?path=${encodeURIComponent(path)}`);
  const parts = path.split("/").filter(Boolean);
  let acc = "";
  const crumbs = [`<a href="#/allocations/${jsArg(allocId)}/fs">/</a>`]
    .concat(parts.map(p => {
      acc += "/" + p;
      return `<a href="#/allocations/${jsArg(allocId)}/fs${hashPath(acc)}">${esc(p)}</a>`;
    })).join(" / ");
  render(`
    <h1>Files <span class="mono" style="font-size:14px">${shortId(allocId)}</span></h1>
    <p class="sub mono">${crumbs}
      (<a href="#/allocations/${jsArg(allocId)}">back to allocation</a>)</p>
    <table id="fs-table"><thead><tr><th>Name</th><th>Size</th><th>Modified</th></tr></thead><tbody>
    ${entries.map(e => {
      const target = (path.endsWith("/") ? path : path + "/") + e.Name;
      const href = e.IsDir
        ? `#/allocations/${jsArg(allocId)}/fs${hashPath(target)}`
        : `#/allocations/${jsArg(allocId)}/cat${hashPath(target)}`;
      return `<tr class="rowlink" onclick="location.hash='${href}'">
        <td class="mono"><a href="${href}">${e.IsDir ? "&#128193; " : ""}${esc(e.Name)}${e.IsDir ? "/" : ""}</a></td>
        <td>${e.IsDir ? "—" : e.Size}</td>
        <td class="muted">${new Date(e.ModTime * 1000).toLocaleString()}</td></tr>`;
    }).join("")}
    </tbody></table>`);
}

async function viewAllocFile(allocId, path) {
  const st = await get(
    `/v1/client/fs/stat/${jsArg(allocId)}?path=${encodeURIComponent(path)}`);
  const dir = path.replace(/\/[^/]*$/, "") || "/";
  const limit = 256 * 1024;
  const resp = await get(
    `/v1/client/fs/readat/${jsArg(allocId)}?path=${encodeURIComponent(path)}` +
    `&offset=${Math.max(0, st.Size - limit)}&limit=${limit}`);
  render(`
    <h1>File <span class="mono" style="font-size:14px">${esc(path)}</span></h1>
    <p class="sub mono">${st.Size} bytes
      (<a href="#/allocations/${jsArg(allocId)}/fs${hashPath(dir)}">back to ${esc(dir)}</a>)
      ${st.Size > limit ? `· showing last ${limit} bytes` : ""}</p>
    <pre class="mono" style="background:var(--panel,#111);border:1px solid var(--border,#333);border-radius:8px;max-height:65vh;overflow:auto;padding:12px;white-space:pre-wrap">${esc(resp.Data || "")}</pre>`);
}

/* ---------- log tailing (ui task logs analog) ---------------------- */

const LOG_ROUTE = /^#\/allocations\/[^/]+\/logs\//;
let logAbort = null;
function logCleanup() {
  if (logAbort) { try { logAbort.abort(); } catch (e) {} logAbort = null; }
}
async function viewAllocLogs(allocId, task, logtype) {
  logCleanup();
  logtype = logtype || "stdout";
  const other = logtype === "stdout" ? "stderr" : "stdout";
  render(`
    <h1>Logs <span class="mono" style="font-size:14px">${shortId(allocId)}/${esc(task)}</span></h1>
    <p class="sub">
      <strong>${logtype}</strong> ·
      <a href="#/allocations/${jsArg(allocId)}/logs/${jsArg(task)}/${other}">${other}</a> ·
      <label><input type="checkbox" id="log-follow" checked> follow</label>
      (<a href="#/allocations/${jsArg(allocId)}">back to allocation</a>)</p>
    <pre id="logpane" class="mono" style="background:var(--panel,#111);border:1px solid var(--border,#333);border-radius:8px;min-height:320px;max-height:65vh;overflow:auto;padding:12px;white-space:pre-wrap"></pre>`);
  const pane = document.getElementById("logpane");
  const follow = document.getElementById("log-follow");
  const append = (text) => {
    pane.textContent += text;
    if (follow.checked) pane.scrollTop = pane.scrollHeight;
  };
  /* follow via the chunked ?follow=true stream (fs_endpoint.go Logs);
     falls back to a one-shot read when streaming is unavailable */
  const headers = {};
  if (token()) headers["X-Nomad-Token"] = token();
  logAbort = new AbortController();
  const qs = new URLSearchParams({ task, type: logtype, follow: "true" });
  try {
    const resp = await fetch(
      `/v1/client/fs/logs/${encodeURIComponent(allocId)}?${qs}`,
      { headers, signal: logAbort.signal });
    if (!resp.ok || !resp.body) throw new Error(`HTTP ${resp.status}`);
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    for (;;) {
      const { value, done } = await reader.read();
      if (done) break;
      append(decoder.decode(value, { stream: true }));
    }
    append("\n[log stream ended]\n");
  } catch (e) {
    if (e.name === "AbortError") return;
    try {
      const one = await get(
        `/v1/client/fs/logs/${jsArg(allocId)}?task=${jsArg(task)}&type=${logtype}`);
      append(one.Data || "");
    } catch (e2) { renderError(e2); }
  }
}

/* ---------- exec terminal (ui/app/components/exec analog) ---------- */

let execSocket = null;
function execCleanup() {
  if (execSocket) { try { execSocket.close(); } catch (e) {} execSocket = null; }
}
async function viewExec(allocId, task) {
  execCleanup();
  render(`
    <h1>Exec <span class="mono" style="font-size:14px">${shortId(allocId)}/${esc(task)}</span></h1>
    <p class="sub">interactive session via the agent websocket
      (<a href="#/allocations/${jsArg(allocId)}">back to allocation</a>)</p>
    <div class="actions">
      <input type="text" id="exec-cmd" class="mono" value="/bin/sh" style="width:260px">
      <button id="exec-start">Start</button>
      <button id="exec-stop" class="danger" disabled>Close</button>
      <span id="exec-status" class="muted"></span>
    </div>
    <pre id="term" class="mono" style="background:var(--panel,#111);border:1px solid var(--border,#333);border-radius:8px;min-height:320px;max-height:60vh;overflow:auto;padding:12px;white-space:pre-wrap"></pre>
    <div class="actions">
      <span class="mono muted">stdin&gt;</span>
      <input type="text" id="exec-stdin" class="mono" style="flex:1;width:60%" disabled>
    </div>
  `);
  const term = document.getElementById("term");
  const status = document.getElementById("exec-status");
  const stdin = document.getElementById("exec-stdin");
  const startBtn = document.getElementById("exec-start");
  const stopBtn = document.getElementById("exec-stop");
  const append = (text) => {
    term.textContent += text;
    term.scrollTop = term.scrollHeight;
  };
  const b64decode = (d) => {
    try { return atob(d); } catch (e) { return ""; }
  };
  startBtn.onclick = () => {
    execCleanup();
    term.textContent = "";
    const cmdText = document.getElementById("exec-cmd").value.trim() || "/bin/sh";
    /* shell-ish split: quoted args stay whole */
    const cmd = cmdText.match(/(?:[^\s"]+|"[^"]*")+/g).map(w => w.replace(/^"|"$/g, ""));
    const proto = location.protocol === "https:" ? "wss:" : "ws:";
    const qs = new URLSearchParams({
      task, tty: "false", command: JSON.stringify(cmd),
    });
    if (token()) qs.set("x_nomad_token", token());
    const ns = localStorage.getItem("nomad_namespace") || "";
    if (ns) qs.set("namespace", ns);
    const url = `${proto}//${location.host}/v1/client/allocation/${encodeURIComponent(allocId)}/exec?${qs}`;
    const sock = new WebSocket(url);
    execSocket = sock;
    status.textContent = "connecting…";
    sock.onopen = () => {
      status.textContent = "connected";
      stdin.disabled = false; stopBtn.disabled = false; stdin.focus();
    };
    sock.onmessage = (ev) => {
      let frame;
      try { frame = JSON.parse(ev.data); } catch (e) { return; }
      for (const key of ["stdout", "stderr"]) {
        const d = (frame[key] || {}).data;
        if (d) append(b64decode(d));
      }
      if (frame.exited) {
        const r = frame.result || {};
        append(`\n[session exited: code ${r.exit_code ?? "?"}]\n`);
        status.textContent = "exited";
        stdin.disabled = true; stopBtn.disabled = true;
      }
    };
    sock.onclose = () => {
      if (status.textContent !== "exited") status.textContent = "closed";
      stdin.disabled = true; stopBtn.disabled = true;
    };
    sock.onerror = () => { status.textContent = "error"; };
  };
  stopBtn.onclick = () => { execCleanup(); };
  stdin.onkeydown = (ev) => {
    if (ev.key !== "Enter" || !execSocket) return;
    const line = stdin.value + "\n";
    append(line);
    execSocket.send(JSON.stringify({ stdin: { data: btoa(line) } }));
    stdin.value = "";
  };
}

/* ---------- event-driven live updates ---------- */

/* The event stream (/v1/event/stream, NDJSON) drives list refreshes
   the way the reference UI's blocking queries do; polling remains as
   the fallback cadence when the stream is down. */
let eventStreamHealthy = false;
let eventRefreshTimer = null;
function startEventStream() {
  const headers = {};
  if (token()) headers["X-Nomad-Token"] = token();
  fetch("/v1/event/stream", { headers }).then(async (resp) => {
    if (!resp.ok || !resp.body) throw new Error("stream unavailable");
    eventStreamHealthy = true;
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buf = "";
    for (;;) {
      const { value, done } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      let nl;
      let sawEvent = false;
      while ((nl = buf.indexOf("\n")) >= 0) {
        const line = buf.slice(0, nl).trim();
        buf = buf.slice(nl + 1);
        if (line && line !== "{}") sawEvent = true;  // {} is heartbeat
      }
      if (sawEvent) {
        /* debounce: a plan commit emits bursts */
        clearTimeout(eventRefreshTimer);
        eventRefreshTimer = setTimeout(() => {
          const hash = location.hash || "#/";
          if (hash !== "#/settings" && !hash.includes("/exec/")
              && !LOG_ROUTE.test(hash)) route();
        }, 300);
      }
    }
    throw new Error("stream ended");
  }).catch(() => {
    eventStreamHealthy = false;
    setTimeout(startEventStream, 5000);   // reconnect with backoff
  });
}
startEventStream();

/* ---------- router ---------- */

const routes = [
  [/^#?\/?$/, viewOverview],
  [/^#\/jobs$/, viewJobs],
  [/^#\/jobs\/(.+)$/, (m) => viewJobDetail(decodeURIComponent(m[1]))],
  [/^#\/clients$/, viewClients],
  [/^#\/clients\/(.+)$/, (m) => viewClientDetail(m[1])],
  [/^#\/allocations$/, viewAllocs],
  [/^#\/allocations\/([^/]+)\/exec\/(.+)$/,
    (m) => viewExec(decodeURIComponent(m[1]), decodeURIComponent(m[2]))],
  [/^#\/allocations\/([^/]+)\/fs(\/.*)?$/,
    (m) => viewAllocFs(decodeURIComponent(m[1]),
                       decodeURIComponent(m[2] || "/"))],
  [/^#\/allocations\/([^/]+)\/cat(\/.+)$/,
    (m) => viewAllocFile(decodeURIComponent(m[1]),
                         decodeURIComponent(m[2]))],
  [/^#\/allocations\/([^/]+)\/logs\/([^/]+)(?:\/(stdout|stderr))?$/,
    (m) => viewAllocLogs(decodeURIComponent(m[1]),
                         decodeURIComponent(m[2]), m[3])],
  [/^#\/allocations\/(.+)$/, (m) => viewAllocDetail(m[1])],
  [/^#\/evaluations$/, viewEvals],
  [/^#\/deployments$/, viewDeployments],
  [/^#\/services$/, viewServices],
  [/^#\/volumes$/, viewVolumes],
  [/^#\/volumes\/(.+)$/, (m) => viewVolumeDetail(decodeURIComponent(m[1]))],
  [/^#\/plugins\/(.+)$/, (m) => viewPluginDetail(decodeURIComponent(m[1]))],
  [/^#\/acl$/, viewACL],
  [/^#\/acl\/policies\/(.+)$/, (m) => viewACLPolicy(decodeURIComponent(m[1]))],
  [/^#\/topology$/, viewTopology],
  [/^#\/servers$/, viewServers],
  [/^#\/settings$/, viewSettings],
];

async function route() {
  const hash = location.hash || "#/";
  if (!LOG_ROUTE.test(hash)) logCleanup();   // leaving a log tail
  for (const a of document.querySelectorAll("nav a")) {
    a.classList.toggle("active",
      a.getAttribute("href") === hash ||
      (a.getAttribute("href") !== "#/" && hash.startsWith(a.getAttribute("href") + "/")));
  }
  for (const [re, fn] of routes) {
    const m = hash.match(re);
    if (m) {
      clearInterval(refreshTimer);
      const run = async () => { await fn(m); };
      try { await run(); } catch (e) { render("<h1>error</h1>"); renderError(e); }
      // detail pages refresh too, but more gently; settings never
      // refreshes (it holds form inputs the re-render would wipe) and
      // the exec terminal never re-renders (it owns a live socket).
      // With a healthy event stream driving refreshes, polling drops
      // to a slow safety net.
      if (hash !== "#/settings" && !hash.includes("/exec/")
          && !LOG_ROUTE.test(hash)) {   // a log tail owns a stream
        const base = hash.split("/").length > 2 ? 6000 : 4000;
        autoRefresh(run, eventStreamHealthy ? 30000 : base);
      }
      return;
    }
  }
  render(`<h1>not found</h1><p class="sub">${esc(hash)}</p>`);
}

window.addEventListener("hashchange", route);
document.getElementById("theme-toggle").onclick = () => {
  const cur = document.documentElement.dataset.theme ||
    (matchMedia("(prefers-color-scheme: dark)").matches ? "dark" : "light");
  const next = cur === "dark" ? "light" : "dark";
  document.documentElement.dataset.theme = next;
  localStorage.setItem("nomad_theme", next);
};
if (localStorage.getItem("nomad_theme")) {
  document.documentElement.dataset.theme = localStorage.getItem("nomad_theme");
}
get("/v1/agent/members").then((m) => {
  document.getElementById("nav-region").textContent = m.ServerRegion || "";
}).catch(() => {});
route();
