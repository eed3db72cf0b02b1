"""The operator's control panel at ``GET /``: one dependency-free HTML page.

A copy of the JAX package's ``server/panel.py``, byte for byte: the
reference extension's Status, Worker Config and Settings tabs. It polls
``GET /internal/status`` every 1.5 s (the worker table with states,
speeds, pixel caps, checkpoint pins and their validation, the settings,
progress, stage timings and the log ring) and drives the fleet through
the port's routes: ``POST /internal/workers`` (add, update, remove;
enable and disable), ``POST /internal/worker-models`` (the pin
dropdown), ``POST /internal/reset-mpe``, ``POST /internal/user-script``,
``POST /internal/restart-all`` (confirmed client-side), ``POST
/internal/benchmark``, ``POST /sdapi/v1/interrupt`` and ``POST
/sdapi/v1/options`` (the runtime settings). Its help text speaks of the
JAX package's TPU mesh where the port's master runs on its card.
"""

PANEL_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>sdtpu — distributed control</title>
<style>
  body { font-family: ui-monospace, monospace; background: #101418;
         color: #d5dbe1; margin: 2rem; }
  h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.4rem; }
  table { border-collapse: collapse; min-width: 36rem; }
  td, th { border: 1px solid #2a3138; padding: .35rem .7rem;
           text-align: left; font-size: .85rem; }
  th { background: #1a2026; }
  .IDLE { color: #7bd88f; } .WORKING { color: #ffd866; }
  .UNAVAILABLE { color: #ff6188; } .DISABLED { color: #727072; }
  .INTERRUPTED { color: #fc9867; }
  #logs { white-space: pre; background: #0b0e11; padding: .8rem;
          border: 1px solid #2a3138; font-size: .8rem; max-width: 72rem;
          overflow-x: auto; }
  #bar { height: 6px; background: #2a3138; width: 36rem; }
  #fill { height: 6px; background: #7bd88f; width: 0; }
  button { background: #1a2026; color: #d5dbe1; border: 1px solid #2a3138;
           padding: .25rem .7rem; cursor: pointer; font: inherit; }
  button:hover { background: #2a3138; }
  input[type=number] { width: 6rem; }
  input, label { font: inherit; background: #0b0e11; color: #d5dbe1;
                 border: 1px solid #2a3138; }
  .danger { border-color: #ff6188; }
  #settings label { border: 0; background: none; margin-right: 1.2rem; }
</style>
</head>
<body>
<h1>sdtpu &mdash; TPU-native distributed Stable Diffusion</h1>
<div>model: <span id="model">?</span> &middot; job: <span id="job"></span>
  <span id="step"></span></div>
<div id="bar"><div id="fill"></div></div>
<p>
  <button onclick="post('/sdapi/v1/interrupt', {})">interrupt all</button>
  <button onclick="benchmark()">re-benchmark</button>
  <button onclick="post('/internal/reset-mpe', {})">reset MPE</button>
  <button onclick="post('/internal/user-script', {})">run sync script</button>
  <button class="danger" onclick="restartAll()">restart all workers</button>
</p>
<h2>workers</h2>
<table><thead><tr><th>label</th><th>state</th><th>speed</th><th>master</th>
<th>pixel cap</th><th>model pin</th><th></th><th></th></tr></thead>
<tbody id="workers"></tbody></table>
<form id="addworker" onsubmit="return addWorker()">
  <label>label <input id="aw_label" size="10"></label>
  <label>address <input id="aw_address" size="14"></label>
  <label>port <input type="number" id="aw_port" value="7860"></label>
  <label><input type="checkbox" id="aw_tls"> tls</label>
  <label>user <input id="aw_user" size="8"></label>
  <label>password <input type="password" id="aw_password" size="8"></label>
  <button type="submit">add worker</button>
</form>
<h2>edit worker</h2>
<form id="editworker" onsubmit="return saveWorker()">
  <label>worker <select id="ew_label"
    onchange="fillEditForm()"></select></label>
  <label>address <input id="ew_address" size="14"></label>
  <label>port <input type="number" id="ew_port"></label>
  <label><input type="checkbox" id="ew_tls"> tls</label>
  <label>user <input id="ew_user" size="8"></label>
  <label>password <input type="password" id="ew_password" size="8"
    placeholder="(unchanged)"></label>
  <label>model pin <input id="ew_pin" list="ew_pin_models" size="22"
    placeholder="(follow fleet)"><datalist id="ew_pin_models"></datalist>
  </label>
  <label>pixel cap <input type="number" id="ew_cap" min="0"></label>
  <button type="submit">save worker</button>
</form>
<h2>settings</h2>
<form id="settings" onsubmit="return saveSettings()">
  <label>job timeout (s)
    <input type="number" id="job_timeout" min="0" step="1"></label>
  <label><input type="checkbox" id="complement_production">
    complementary production</label>
  <label><input type="checkbox" id="step_scaling"> step scaling</label>
  <label><input type="checkbox" id="thin_client_mode"> thin client</label>
  <button type="submit">apply</button>
</form>
<h2>stage timings (p50)</h2>
<table><thead><tr><th>stage</th><th>p50</th><th>mean</th><th>count</th>
</tr></thead><tbody id="timings"></tbody></table>
<h2>log</h2>
<div id="logs"></div>
<details id="help"><summary>help</summary>
<p><b>Workers.</b> The fleet is a master (this process, generating
locally on its TPU mesh) plus any number of remote sdapi-v1 nodes —
other instances of this framework or legacy sdwui servers. States:
<span class="IDLE">IDLE</span> (schedulable),
<span class="WORKING">WORKING</span> (request in flight),
<span class="UNAVAILABLE">UNAVAILABLE</span> (failed a request or ping;
revived automatically by the next successful ping),
<span class="DISABLED">DISABLED</span> (operator-excluded). The speed
column is the measured benchmark average (images/minute); re-run it with
<i>re-benchmark</i> after hardware changes.</p>
<p><b>Per-worker controls.</b> <i>model pin</i> holds a worker on one
checkpoint regardless of fleet-wide model syncs (validated against the
models that worker actually serves; a &#9888; marks a pin accepted
while its node was unreachable — it is re-checked automatically on the
next successful ping); <i>pixel cap</i> bounds
width&times;height&times;batch per job (0 = uncapped); <i>disable</i>
keeps the worker registered but unscheduled. Edit a registered worker's
address/port/tls/credentials in the <i>edit worker</i> form — leave the
password blank to keep the stored one.</p>
<p><b>Settings.</b> <i>job timeout</i>: seconds a worker may lag behind
the fastest before it is dropped from a request (quicker fleets want it
small); <i>complementary production</i>: idle workers render bonus
images beyond the requested batch; <i>step scaling</i>: slower workers
run fewer steps instead of fewer images; <i>thin client</i>: the master
only orchestrates and renders nothing locally.</p>
<p><b>Interrupts.</b> <i>interrupt all</i> aborts the in-flight
generation everywhere (mid-denoise on the master, via /interrupt on
remotes). There is no pending-request queue to clear: requests are
executed synchronously, so interrupting the current one empties the
node (the reference's debug clear-queue button has no equivalent state
here).</p>
<p><b>reset MPE</b> clears every worker's ETA error history — use it
after driver or hardware changes that invalidate old calibration.
<b>run sync script</b> executes the operator's <code>sync*</code> hook
from the config dir's <code>user/</code> folder (e.g. rsync models to
workers).</p>
</details>
<script>
async function post(url, body) {
  try {
    const r = await fetch(url, {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    if (!r.ok) {  // surface validation errors (e.g. a rejected model pin)
      let msg = 'error ' + r.status;
      try { msg = (await r.json()).detail || msg; } catch (e) {}
      alert(msg);
    }
  } catch (e) { /* server restarting */ }
  tick();
}
function restartAll() {
  // the reference keeps this confirm client-side (distributed.js:2-4)
  if (confirm('Restart ALL workers?')) post('/internal/restart-all', {});
}
function benchmark() { post('/internal/benchmark', {rebenchmark: true}); }
// workers cached by index: handlers never interpolate server-provided
// strings into JS or HTML (a label/pin containing quotes must not become
// markup — stored-XSS guard)
let workerRows = [];
const esc = s => String(s).replace(/[&<>"']/g, c => ({
  '&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;', "'": '&#39;'}[c]));
function setPin(i) {
  // route to the edit-worker form: its pin input carries a <datalist>
  // fed by that worker's actual model list (reference ui.py:161-171),
  // so pins are picked, not typed blind (free text still allowed)
  const w = workerRows[i];
  const sel = document.getElementById('ew_label');
  sel.value = w.label;
  fillEditForm();
  document.getElementById('editworker').scrollIntoView();
  document.getElementById('ew_pin').focus();
}
function setCap(i) {
  const w = workerRows[i];
  const v = prompt(`pixel cap for '${w.label}' (width*height*batch, 0 = ` +
                   'uncapped)', w.pixel_cap || '0');
  if (v !== null) post('/internal/workers',
                       {label: w.label, pixel_cap: parseInt(v) || 0});
}
function toggle(i) {
  const w = workerRows[i];
  post('/internal/workers', {label: w.label, disabled: !w.disabled});
}
function removeWorker(i) {
  const w = workerRows[i];
  if (confirm(`Remove worker '${w.label}' from the fleet?`))
    post('/internal/workers', {action: 'remove', label: w.label});
}
function addWorker() {
  post('/internal/workers', {
    action: 'add',
    label: document.getElementById('aw_label').value,
    address: document.getElementById('aw_address').value,
    port: parseInt(document.getElementById('aw_port').value) || 7860,
    tls: document.getElementById('aw_tls').checked,
    user: document.getElementById('aw_user').value,
    password: document.getElementById('aw_password').value,
  });
  return false;
}
// edit-worker form: select a worker, prefill its endpoint fields, fetch
// its model list for the pin dropdown (reference ui.py:100-171)
function refreshEditSelect() {
  const sel = document.getElementById('ew_label');
  const cur = sel.value;
  const labels = workerRows.map(w => w.label);
  if (labels.join('\\u0000') === sel.dataset.labels) return;
  sel.dataset.labels = labels.join('\\u0000');
  sel.innerHTML = workerRows.map(w => {
    const o = document.createElement('option');
    o.value = o.textContent = w.label;
    return o.outerHTML;
  }).join('');
  sel.value = labels.includes(cur) ? cur : (labels[0] || '');
  if (sel.value) fillEditForm();
}
async function fillEditForm() {
  const w = workerRows.find(x => x.label ===
    document.getElementById('ew_label').value);
  if (!w) return;
  const remote = !w.master && w.address !== undefined;
  for (const f of ['address', 'port', 'user'])
    document.getElementById('ew_' + f).value = remote ? (w[f] ?? '') : '';
  for (const f of ['address', 'port', 'tls', 'user', 'password'])
    document.getElementById('ew_' + f).disabled = !remote;
  document.getElementById('ew_tls').checked = remote && !!w.tls;
  document.getElementById('ew_password').value = '';
  document.getElementById('ew_cap').value = w.pixel_cap || 0;
  const pin = document.getElementById('ew_pin');
  const list = document.getElementById('ew_pin_models');
  list.innerHTML = '';
  if (w.model_override) addPinOption(list, w.model_override);
  pin.value = w.model_override || '';
  try {
    const r = await fetch('/internal/worker-models', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({label: w.label})});
    const models = (await r.json()).models || [];
    // the operator may have switched workers while the fetch was in
    // flight — never populate another worker's datalist
    if (document.getElementById('ew_label').value !== w.label) return;
    for (const m of models) addPinOption(list, m);
  } catch (e) { /* node down: keep current pin only */ }
}
function addPinOption(sel, name) {
  if ([...sel.options].some(o => o.value === name)) return;
  const o = document.createElement('option');
  o.value = o.textContent = name;
  sel.appendChild(o);
}
async function saveWorker() {
  const label = document.getElementById('ew_label').value;
  const w = workerRows.find(x => x.label === label);
  if (!w) return false;
  const body = {label: label,
    model_override: document.getElementById('ew_pin').value,
    pixel_cap: parseInt(document.getElementById('ew_cap').value) || 0};
  if (!w.master && w.address !== undefined) {
    body.address = document.getElementById('ew_address').value;
    body.port = parseInt(document.getElementById('ew_port').value) || w.port;
    body.tls = document.getElementById('ew_tls').checked;
    body.user = document.getElementById('ew_user').value;
    const pw = document.getElementById('ew_password').value;
    if (pw) body.password = pw;  // blank = keep stored password
  }
  try {
    const r = await fetch('/internal/workers', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    if (!r.ok) alert((await r.json()).detail || 'save failed');
  } catch (e) { alert('save failed: ' + e); }
  tick();
  return false;
}
function saveSettings() {
  post('/sdapi/v1/options', {
    job_timeout: parseInt(document.getElementById('job_timeout').value),
    complement_production:
      document.getElementById('complement_production').checked,
    step_scaling: document.getElementById('step_scaling').checked,
    thin_client_mode: document.getElementById('thin_client_mode').checked,
  });
  return false;
}
let settingsLoaded = false;
async function tick() {
  try {
    const r = await fetch('/internal/status');
    const s = await r.json();
    document.getElementById('model').textContent = s.model || '(none)';
    document.getElementById('job').textContent = s.progress.job || 'idle';
    document.getElementById('step').textContent =
      s.progress.sampling_steps ?
      ` ${s.progress.sampling_step}/${s.progress.sampling_steps}` : '';
    document.getElementById('fill').style.width =
      (100 * (s.progress.fraction || 0)) + '%';
    document.getElementById('timings').innerHTML =
      Object.entries(s.timings).map(([k, v]) =>
        `<tr><td>${k}</td><td>${(v.p50 * 1000).toFixed(1)} ms</td>` +
        `<td>${(v.mean * 1000).toFixed(1)} ms</td><td>${v.count}</td></tr>`
      ).join('');
    document.getElementById('logs').textContent = s.logs.join('\\n');
    workerRows = s.workers;  // one status fetch carries the worker table
    refreshEditSelect();
    document.getElementById('workers').innerHTML = workerRows.map((w, i) =>
      `<tr><td>${esc(w.label)}</td>` +
      `<td class="${esc(w.state)}">${esc(w.state)}</td>` +
      `<td>${w.avg_ipm ? w.avg_ipm.toFixed(2) + ' ipm' : '—'}</td>` +
      `<td>${w.master ? 'yes' : ''}</td>` +
      `<td><a href="#" onclick="setCap(${i});return false">` +
      `${w.pixel_cap || '—'}</a></td>` +
      `<td><a href="#" onclick="setPin(${i});return false" ` +
      `${w.model_override && w.pin_validated === false ?
        'title="pin not confirmed against this worker\\'s model list ' +
        '(node unreachable at set time; re-checked on next ping)"' : ''}>` +
      `${w.model_override ? esc(w.model_override) +
        (w.pin_validated === false ? ' &#9888;' : '') : '—'}</a></td>` +
      `<td><button onclick="toggle(${i})">` +
      `${w.disabled ? 'enable' : 'disable'}</button></td>` +
      `<td>${w.master ? '' :
        `<button class="danger" onclick="removeWorker(${i})">x</button>`}` +
      `</td></tr>`).join('');
    if (!settingsLoaded && s.settings) {
      document.getElementById('job_timeout').value = s.settings.job_timeout;
      document.getElementById('complement_production').checked =
        s.settings.complement_production;
      document.getElementById('step_scaling').checked =
        s.settings.step_scaling;
      document.getElementById('thin_client_mode').checked =
        s.settings.thin_client_mode;
      settingsLoaded = true;
    }
  } catch (e) { /* server restarting */ }
}
setInterval(tick, 1500);  // reference cadence: distributed.js polls at 1.5 s
tick();
</script>
</body>
</html>
"""
