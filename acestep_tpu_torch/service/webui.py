"""Built-in single-page studio UI served at `/` by the port's API server.

A copy of `acestep_tpu/service/webui.py`: a static page over the job API
(generation modes, caption and lyrics, metadata, the planner's controls,
batch results with audio players). Its training tab and dataset explorer
call `/v1/train/*` and `/v1/dataset/*` (`service/train_api.py`).
"""

STUDIO_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>ACE-Step TPU Studio</title>
<style>
  :root { color-scheme: dark; }
  body { font-family: system-ui, sans-serif; background: #111418; color: #e6e6e6;
         max-width: 900px; margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.4rem; } h1 span { color: #6ae3ff; }
  fieldset { border: 1px solid #2a2f36; border-radius: 8px; margin-bottom: 1rem; }
  legend { color: #9ad; padding: 0 .4rem; }
  label { display: block; margin: .5rem 0 .15rem; font-size: .85rem; color: #aab; }
  input[type=text], input[type=number], textarea, select {
    width: 100%; box-sizing: border-box; background: #1a1f26; color: #e6e6e6;
    border: 1px solid #2a2f36; border-radius: 6px; padding: .45rem; }
  textarea { min-height: 70px; font-family: inherit; }
  .row { display: flex; gap: .8rem; } .row > div { flex: 1; }
  .modes label { display: inline-block; margin-right: .9rem; }
  button { background: #2563eb; color: white; border: 0; border-radius: 6px;
           padding: .6rem 1.4rem; font-size: 1rem; cursor: pointer; margin-top: .6rem; }
  button:disabled { background: #444; }
  #status { margin: .8rem 0; color: #9ad; min-height: 1.2em; }
  .result { background: #1a1f26; border-radius: 8px; padding: .8rem; margin: .6rem 0; }
  audio { width: 100%; }
  progress { width: 100%; height: 8px; }
  .small { font-size: .75rem; color: #778; }
</style>
</head>
<body>
<h1>ACE-Step <span>TPU</span> Studio
  <select id="lang" style="float: inline-end; width: auto; font-size: .8rem">
    <option value="en">English</option><option value="zh">中文</option>
    <option value="ja">日本語</option><option value="he">עברית</option>
  </select>
  <input type="password" id="api_key" placeholder="API key"
         style="float: inline-end; width: 8rem; font-size: .8rem; margin-inline-end: .5rem"
         title="Only needed when the server was started with --api-key">
</h1>

<fieldset class="modes"><legend>Tab</legend>
  <label><input type="radio" name="tab" value="generate" checked> Generate</label>
  <label><input type="radio" name="tab" value="training"> Training</label>
</fieldset>

<div id="tab-generate">
<fieldset class="modes"><legend>Mode</legend>
  <label><input type="radio" name="mode" value="Simple" checked> Simple</label>
  <label><input type="radio" name="mode" value="Custom"> Custom</label>
  <label><input type="radio" name="mode" value="Remix"> Remix</label>
  <label><input type="radio" name="mode" value="Repaint"> Repaint</label>
  <label><input type="radio" name="mode" value="Extract"> Extract</label>
  <label><input type="radio" name="mode" value="Lego"> Lego</label>
  <label><input type="radio" name="mode" value="Complete"> Complete</label>
</fieldset>

<fieldset id="simpleRow"><legend>Simple</legend>
  <label>Describe your song (the LM drafts caption, lyrics and metadata)</label>
  <input type="text" id="simple_query" placeholder="a dreamy bedroom-pop song about summer rain">
</fieldset>

<fieldset><legend>Prompt</legend>
  <label>Caption</label>
  <input type="text" id="caption" placeholder="an energetic synthwave track with driving bass">
  <label>Lyrics ([Instrumental] for none)</label>
  <textarea id="lyrics">[Instrumental]</textarea>
  <div class="row">
    <div><button id="btn_example" class="tool">Sample example</button></div>
    <div><button id="btn_create" class="tool">Create sample</button></div>
    <div><button id="btn_format" class="tool">Format input</button></div>
    <div><button id="btn_understand" class="tool">Understand codes</button></div>
  </div>
  <div id="understandRow" style="display:none">
    <label>Audio codes</label>
    <input type="text" id="u_codes" placeholder="<|audio_code_123|>...">
  </div>
  <label>Load params (JSON sidecar from a previous result)</label>
  <input type="file" id="load_params" accept=".json,application/json">
  <div id="tool_status" class="small"></div>
</fieldset>

<fieldset><legend>Settings</legend>
  <div class="row">
    <div><label>Duration (s)</label><input type="number" id="duration" value="30" min="10" max="600"></div>
    <div><label>BPM</label><input type="number" id="bpm" placeholder="auto"></div>
    <div><label>Key</label><input type="text" id="keyscale" placeholder="auto"></div>
    <div><label>Seed</label><input type="number" id="seed" value="-1"></div>
  </div>
  <div class="row">
    <div><label>Batch</label><input type="number" id="batch" value="1" min="1" max="8"></div>
    <div><label>Steps</label><input type="number" id="steps" value="8" min="1" max="100"></div>
    <div><label>Guidance</label><input type="number" id="guidance" value="7.0" step="0.5"></div>
    <div><label>Format</label>
      <select id="format"><option>wav</option><option>flac</option><option>mp3</option></select>
    </div>
  </div>
  <label><input type="checkbox" id="instrumental"> Instrumental (no vocals)</label>
  <label><input type="checkbox" id="thinking" checked> LM thinking (CoT metadata + codes)</label>
  <label><input type="checkbox" id="auto_lrc"> Auto LRC (lyric timestamps)</label>
  <label><input type="checkbox" id="auto_score"> Auto lyric quality score</label>
  <div class="row" id="repaintRow" style="display:none">
    <div><label>Repaint start (s)</label><input type="number" id="rstart" value="0"></div>
    <div><label>Repaint end (s)</label><input type="number" id="rend" value="-1"></div>
  </div>
  <div id="genCodesRow" style="display:none">
    <label>Audio codes (optional; switches generation to cover)</label>
    <textarea id="gen_codes" placeholder="<|audio_code_123|>..."></textarea>
  </div>
</fieldset>

<details id="advanced"><summary class="small" style="margin-bottom:.5rem">Advanced settings</summary>
<fieldset><legend>Advanced</legend>
  <div class="row">
    <div><label>LM temperature</label><input type="number" id="lm_temperature" value="0.85" step="0.05" min="0" max="2"></div>
    <div><label>LM CFG scale</label><input type="number" id="lm_cfg_scale" value="2.0" step="0.1" min="1"></div>
    <div><label>LM top-k (0 = off)</label><input type="number" id="lm_top_k" value="0" min="0"></div>
    <div><label>LM top-p</label><input type="number" id="lm_top_p" value="0.9" step="0.05" min="0" max="1"></div>
  </div>
  <div class="row">
    <div><label>LM repetition penalty</label><input type="number" id="lm_rep_pen" value="1.0" step="0.05" min="0.5" max="2"></div>
    <div><label>Shift</label><input type="number" id="adv_shift" value="1.0" step="0.5" min="0.5"></div>
    <div><label>Infer method</label>
      <select id="infer_method"><option>ode</option><option>sde</option></select></div>
    <div><label>Vocal language</label>
      <input type="text" id="vocal_language" placeholder="unknown"></div>
  </div>
  <div class="row">
    <div><label>CFG interval start</label><input type="number" id="cfg_start" value="0.0" step="0.05" min="0" max="1"></div>
    <div><label>CFG interval end</label><input type="number" id="cfg_end" value="1.0" step="0.05" min="0" max="1"></div>
  </div>
  <label><input type="checkbox" id="use_adg"> ADG (angle-based dynamic guidance)</label>
  <label><input type="checkbox" id="use_cot_metas" checked> Use CoT metadata (bpm/key/duration from LM)</label>
  <label><input type="checkbox" id="use_cot_caption" checked> Use CoT caption</label>
</fieldset>
</details>

<fieldset id="audioRow" style="display:none"><legend>Audio input</legend>
  <label>Source audio (the track to remix / repaint / extract / lego / complete)</label>
  <input type="file" id="src_file" accept="audio/*,.wav,.flac,.mp3,.ogg,.opus,.aac,.m4a">
  <div id="src_info" class="small"></div>
  <div id="refRow">
    <label>Reference audio for timbre (optional, multiple allowed)</label>
    <input type="file" id="ref_files" accept="audio/*,.wav,.flac,.mp3,.ogg,.opus,.aac,.m4a" multiple>
  </div>
  <div class="row" id="strengthRow">
    <div><label>Cover strength</label>
      <input type="number" id="cover_strength" value="1.0" min="0" max="1" step="0.05"></div>
    <div id="coverNoiseCol"><label>Cover noise</label>
      <input type="number" id="cover_noise" value="0.0" min="0" max="1" step="0.05"></div>
  </div>
  <div id="trackRow" style="display:none">
    <label>Track name (stem to extract / generate)</label>
    <input type="text" id="track_name" list="track_names" placeholder="drums">
    <datalist id="track_names">
      <option>vocals</option><option>backing_vocals</option><option>drums</option>
      <option>bass</option><option>guitar</option><option>keyboard</option>
      <option>percussion</option><option>strings</option><option>synth</option>
      <option>fx</option><option>brass</option><option>woodwinds</option>
    </datalist>
  </div>
  <div id="classesRow" style="display:none">
    <label>Track classes to add (comma-separated)</label>
    <input type="text" id="track_classes" placeholder="drums, bass">
  </div>
</fieldset>

<button id="go">Generate</button>
<div id="status"></div>
<progress id="bar" value="0" max="1" style="display:none"></progress>
<div id="results"></div>
</div>

<div id="tab-training" style="display:none">
<fieldset><legend>Dataset explorer</legend>
  <div class="row">
    <div><label>Audio directory (on server)</label><input type="text" id="dx_dir" placeholder="/data/songs"></div>
    <div><label>Labels file path</label><input type="text" id="dx_labels" placeholder="/data/songs/labels.json"></div>
  </div>
  <div class="row">
    <div><button id="dx_scan" class="tool">Scan</button></div>
    <div><button id="dx_load" class="tool">Load labels</button></div>
    <div><button id="dx_save" class="tool">Save labels</button></div>
    <div><button id="dx_label" class="tool">Auto-label unlabeled</button></div>
    <div><button id="dx_prep" class="tool">Preprocess to tensors</button></div>
  </div>
  <div id="dx_status" class="small"></div>
  <div id="dx_table"></div>
</fieldset>

<fieldset><legend>Build dataset</legend>
  <div class="row">
    <div><label>Audio directory (on server)</label><input type="text" id="ds_audio_dir" placeholder="/data/songs"></div>
    <div><label>Output dataset dir</label><input type="text" id="ds_out_dir" placeholder="/data/dataset"></div>
  </div>
  <label><input type="checkbox" id="ds_label_lm"> LM-assisted labeling (understand on codes)</label>
  <label><input type="checkbox" id="ds_format_lyrics"> Format preloaded lyrics with LM</label>
  <button id="build_ds">Build dataset</button>
  <div id="ds_status" class="small"></div>
  <div id="ds_labels" class="small"></div>
</fieldset>

<fieldset><legend>LoRA run</legend>
  <div class="row">
    <div><label>Dataset dir</label><input type="text" id="tr_dataset" placeholder="/data/dataset"></div>
    <div><label>Output dir</label><input type="text" id="tr_out" placeholder="auto"></div>
  </div>
  <div class="row">
    <div><label>Rank</label><input type="number" id="tr_rank" value="32"></div>
    <div><label>Alpha</label><input type="number" id="tr_alpha" value="32"></div>
    <div><label>LR</label><input type="text" id="tr_lr" value="1e-4"></div>
    <div><label>Max steps</label><input type="number" id="tr_steps" value="1000"></div>
  </div>
  <div class="row">
    <div><label>Batch</label><input type="number" id="tr_batch" value="1"></div>
    <div><label>Checkpoint every</label><input type="number" id="tr_ckpt" value="200"></div>
    <div><label>Seed</label><input type="number" id="tr_seed" value="0"></div>
  </div>
  <button id="tr_start">Start training</button>
  <div id="tr_status" class="small"></div>
</fieldset>

<fieldset><legend>Runs</legend>
  <button id="tr_refresh">Refresh</button>
  <div id="tr_runs"></div>
</fieldset>
</div>

<script>
const MODE_TASK = {Simple:"text2music", Custom:"text2music", Remix:"cover",
                   Repaint:"repaint", Extract:"extract", Lego:"lego", Complete:"complete"};
const $ = id => document.getElementById(id);

// ---- i18n (reference ships en/zh/ja/he, SURVEY §2.6) ----
const I18N = {
  zh: {"Send to Repaint":"发送到重绘","Describe your song (the LM drafts caption, lyrics and metadata)":"描述你的歌曲（LM 将生成描述、歌词和元数据）","drafting with the LM…":"LM 创作中…","Sample example":"随机示例","Advanced settings":"高级设置","Advanced":"高级","LM temperature":"LM 温度","LM CFG scale":"LM CFG 系数","LM top-k (0 = off)":"LM top-k（0 为关闭）","LM top-p":"LM top-p","LM repetition penalty":"LM 重复惩罚","Shift":"Shift","Infer method":"推理方法","Vocal language":"人声语言","CFG interval start":"CFG 区间起点","CFG interval end":"CFG 区间终点","ADG (angle-based dynamic guidance)":"ADG（角度动态引导）","Use CoT metadata (bpm/key/duration from LM)":"使用 CoT 元数据（LM 生成的 BPM/调式/时长）","Use CoT caption":"使用 CoT 描述","Load params (JSON sidecar from a previous result)":"加载参数（来自历史结果的 JSON 文件）","Instrumental (no vocals)":"纯音乐（无人声）","Send to Remix":"发送到翻唱","Audio codes (optional; switches generation to cover)":"音频码（可选；提供后切换为翻唱生成）","Track name (stem to extract / generate)":"音轨名称（要提取/生成的分轨）","Track classes to add (comma-separated)":"要补充的音轨类型（逗号分隔）","Audio input":"音频输入","Source audio (the track to remix / repaint / extract / lego / complete)":"源音频（要翻唱/重绘/提取/叠轨/补全的曲目）","Reference audio for timbre (optional, multiple allowed)":"音色参考音频（可选，可多个）","Cover strength":"翻唱强度","Cover noise":"翻唱噪声","This mode needs a source audio file":"此模式需要上传源音频文件","Tab":"标签页","Generate":"生成","Training":"训练","Mode":"模式","Simple":"简单",
       "Custom":"自定义","Remix":"翻唱","Repaint":"重绘","Extract":"提取","Lego":"叠轨",
       "Complete":"补全","Prompt":"提示词","Caption":"描述",
       "Lyrics ([Instrumental] for none)":"歌词（纯音乐填 [Instrumental]）","Settings":"设置",
       "Duration (s)":"时长（秒）","Key":"调式","Seed":"种子","Batch":"批量","Steps":"步数",
       "Guidance":"引导系数","Format":"格式",
       "LM thinking (CoT metadata + codes)":"LM 思考（CoT 元数据 + 音频码）",
       "Repaint start (s)":"重绘起点（秒）","Repaint end (s)":"重绘终点（秒）",
       "Build dataset":"构建数据集","Audio directory (on server)":"音频目录（服务器上）",
       "Output dataset dir":"数据集输出目录","LoRA run":"LoRA 训练","Dataset dir":"数据集目录",
       "Output dir":"输出目录","Rank":"秩","LR":"学习率","Max steps":"最大步数",
       "Checkpoint every":"保存间隔","Start training":"开始训练","Runs":"运行记录","Alpha":"Alpha","BPM":"BPM",
       "Refresh":"刷新","Stop":"停止","Create sample":"生成示例","Format input":"格式化输入","Understand codes":"解析音频码","Audio codes":"音频码","Auto LRC (lyric timestamps)":"自动 LRC（歌词时间戳）","Auto lyric quality score":"自动歌词质量评分","LM-assisted labeling (understand on codes)":"LM 辅助标注（基于音频码理解）","Format preloaded lyrics with LM":"用 LM 格式化已有歌词","Dataset explorer":"数据集浏览器","Labels file path":"标注文件路径","Scan":"扫描","Load labels":"加载标注","Save labels":"保存标注","Auto-label unlabeled":"自动标注未标注项","Preprocess to tensors":"预处理为张量"},
  ja: {"Send to Repaint":"リペイントへ送る","Describe your song (the LM drafts caption, lyrics and metadata)":"曲のイメージを記述（LM がキャプション・歌詞・メタデータを作成）","drafting with the LM…":"LM が作成中…","Sample example":"サンプル例","Advanced settings":"詳細設定","Advanced":"詳細","LM temperature":"LM 温度","LM CFG scale":"LM CFG スケール","LM top-k (0 = off)":"LM top-k（0 で無効）","LM top-p":"LM top-p","LM repetition penalty":"LM 反復ペナルティ","Shift":"シフト","Infer method":"推論方式","Vocal language":"ボーカル言語","CFG interval start":"CFG 区間開始","CFG interval end":"CFG 区間終了","ADG (angle-based dynamic guidance)":"ADG（角度ベース動的ガイダンス）","Use CoT metadata (bpm/key/duration from LM)":"CoT メタデータを使用（LM の BPM/キー/長さ）","Use CoT caption":"CoT キャプションを使用","Load params (JSON sidecar from a previous result)":"パラメータ読込（過去の結果の JSON サイドカー）","Instrumental (no vocals)":"インストゥルメンタル（ボーカルなし）","Send to Remix":"リミックスへ送る","Audio codes (optional; switches generation to cover)":"オーディオコード（任意；指定するとカバー生成に切替）","Track name (stem to extract / generate)":"トラック名（抽出／生成するステム）","Track classes to add (comma-separated)":"追加するトラック種別（カンマ区切り）","Audio input":"オーディオ入力","Source audio (the track to remix / repaint / extract / lego / complete)":"ソース音声（リミックス／リペイント／抽出／レゴ／補完する曲）","Reference audio for timbre (optional, multiple allowed)":"音色リファレンス音声（任意・複数可）","Cover strength":"カバー強度","Cover noise":"カバーノイズ","This mode needs a source audio file":"このモードにはソース音声ファイルが必要です","Tab":"タブ","Generate":"生成","Training":"学習","Mode":"モード","Simple":"シンプル",
       "Custom":"カスタム","Remix":"リミックス","Repaint":"リペイント","Extract":"抽出",
       "Lego":"レゴ","Complete":"補完","Prompt":"プロンプト","Caption":"キャプション",
       "Lyrics ([Instrumental] for none)":"歌詞（なしは [Instrumental]）","Settings":"設定",
       "Duration (s)":"長さ（秒）","Key":"キー","Seed":"シード","Batch":"バッチ",
       "Steps":"ステップ数","Guidance":"ガイダンス","Format":"フォーマット",
       "LM thinking (CoT metadata + codes)":"LM 思考（CoT メタデータ + コード）",
       "Repaint start (s)":"リペイント開始（秒）","Repaint end (s)":"リペイント終了（秒）",
       "Build dataset":"データセット作成","Audio directory (on server)":"音声ディレクトリ（サーバー上）",
       "Output dataset dir":"出力データセットディレクトリ","LoRA run":"LoRA 学習",
       "Dataset dir":"データセットディレクトリ","Output dir":"出力ディレクトリ","Rank":"ランク",
       "LR":"学習率","Max steps":"最大ステップ","Checkpoint every":"チェックポイント間隔","Alpha":"アルファ","BPM":"BPM",
       "Start training":"学習開始","Runs":"実行一覧","Refresh":"更新","Stop":"停止","Create sample":"サンプル作成","Format input":"入力を整形","Understand codes":"コード解析","Audio codes":"オーディオコード","Auto LRC (lyric timestamps)":"自動 LRC（歌詞タイムスタンプ）","Auto lyric quality score":"自動歌詞品質スコア","LM-assisted labeling (understand on codes)":"LM 自動ラベリング（コード理解）","Format preloaded lyrics with LM":"LM で既存歌詞を整形","Dataset explorer":"データセットエクスプローラー","Labels file path":"ラベルファイルパス","Scan":"スキャン","Load labels":"ラベル読込","Save labels":"ラベル保存","Auto-label unlabeled":"未ラベルを自動ラベル","Preprocess to tensors":"テンソルへ前処理"},
  he: {"Send to Repaint":"שלח לצביעה מחדש","Describe your song (the LM drafts caption, lyrics and metadata)":"תארו את השיר (ה-LM ינסח כיתוב, מילים ומטא-נתונים)","drafting with the LM…":"ה-LM מנסח…","Sample example":"דוגמה אקראית","Advanced settings":"הגדרות מתקדמות","Advanced":"מתקדם","LM temperature":"טמפרטורת LM","LM CFG scale":"סולם CFG של LM","LM top-k (0 = off)":"LM top-k (0 = כבוי)","LM top-p":"LM top-p","LM repetition penalty":"קנס חזרה של LM","Shift":"הסטה","Infer method":"שיטת הסקה","Vocal language":"שפת שירה","CFG interval start":"תחילת מרווח CFG","CFG interval end":"סוף מרווח CFG","ADG (angle-based dynamic guidance)":"ADG (הכוונה דינמית מבוססת זווית)","Use CoT metadata (bpm/key/duration from LM)":"שימוש במטא-נתוני CoT (BPM/סולם/משך מה-LM)","Use CoT caption":"שימוש בכיתוב CoT","Load params (JSON sidecar from a previous result)":"טעינת פרמטרים (קובץ JSON מתוצאה קודמת)","Instrumental (no vocals)":"אינסטרומנטלי (ללא שירה)","Send to Remix":"שלח לרמיקס","Audio codes (optional; switches generation to cover)":"קודי אודיו (אופציונלי; מעביר ליצירת קאבר)","Track name (stem to extract / generate)":"שם רצועה (סטם לחילוץ / יצירה)","Track classes to add (comma-separated)":"סוגי רצועות להוספה (מופרד בפסיקים)","Audio input":"קלט אודיו","Source audio (the track to remix / repaint / extract / lego / complete)":"אודיו מקור (הרצועה לרמיקס / צביעה מחדש / חילוץ / לגו / השלמה)","Reference audio for timbre (optional, multiple allowed)":"אודיו ייחוס לגוון (אופציונלי, ניתן כמה)","Cover strength":"עוצמת קאבר","Cover noise":"רעש קאבר","This mode needs a source audio file":"מצב זה דורש קובץ אודיו מקור","Tab":"לשונית","Generate":"יצירה","Training":"אימון","Mode":"מצב","Simple":"פשוט",
       "Custom":"מותאם אישית","Remix":"רמיקס","Repaint":"צביעה מחדש","Extract":"חילוץ",
       "Lego":"לגו","Complete":"השלמה","Prompt":"הנחיה","Caption":"כיתוב",
       "Lyrics ([Instrumental] for none)":"מילים ([Instrumental] ללא מילים)","Settings":"הגדרות",
       "Duration (s)":"משך (שניות)","Key":"סולם","Seed":"זרע","Batch":"אצווה","Steps":"צעדים",
       "Guidance":"הכוונה","Format":"פורמט",
       "LM thinking (CoT metadata + codes)":"חשיבת LM (מטא-נתונים + קודים)",
       "Repaint start (s)":"תחילת צביעה (שניות)","Repaint end (s)":"סוף צביעה (שניות)",
       "Build dataset":"בניית מערך נתונים","Audio directory (on server)":"תיקיית אודיו (בשרת)",
       "Output dataset dir":"תיקיית פלט למערך","LoRA run":"ריצת LoRA",
       "Dataset dir":"תיקיית מערך נתונים","Output dir":"תיקיית פלט","Rank":"דרגה",
       "LR":"קצב למידה","Max steps":"מקס׳ צעדים","Checkpoint every":"שמירה כל","Alpha":"אלפא","BPM":"BPM",
       "Start training":"התחל אימון","Runs":"ריצות","Refresh":"רענון","Stop":"עצירה","Create sample":"צור דוגמה","Format input":"עצב קלט","Understand codes":"נתח קודים","Audio codes":"קודי אודיו","Auto LRC (lyric timestamps)":"LRC אוטומטי (חותמות זמן)","Auto lyric quality score":"ציון איכות מילים אוטומטי","LM-assisted labeling (understand on codes)":"תיוג בעזרת LM (הבנת קודים)","Format preloaded lyrics with LM":"עיצוב מילים קיימות עם LM","Dataset explorer":"סייר מערך נתונים","Labels file path":"נתיב קובץ תיוגים","Scan":"סריקה","Load labels":"טעינת תיוגים","Save labels":"שמירת תיוגים","Auto-label unlabeled":"תיוג אוטומטי ללא-מתויגים","Preprocess to tensors":"עיבוד מקדים לטנזורים"},
};
const _EN = new WeakMap();  // text node -> original English (GC'd with the node)
const t = s => (I18N[$("lang").value] || {})[s] || s;
function applyLang() {
  const dict = I18N[$("lang").value] || {};
  document.documentElement.dir = ($("lang").value === "he") ? "rtl" : "ltr";
  document.querySelectorAll("legend,button,label,summary").forEach(el => {
    if (el.dataset && el.dataset.noI18n !== undefined) return;  // created pre-translated
    [...el.childNodes].forEach(n => {
      if (n.nodeType !== 3 || !n.textContent.trim()) return;
      if (!_EN.has(n)) _EN.set(n, n.textContent.trim());
      const en = _EN.get(n);
      n.textContent = " " + (dict[en] || en) + " ";
    });
  });
}

document.querySelectorAll('input[name=tab]').forEach(r => r.onchange = () => {
  const t = document.querySelector('input[name=tab]:checked').value;
  $("tab-generate").style.display = (t === "generate") ? "block" : "none";
  $("tab-training").style.display = (t === "training") ? "block" : "none";
  if (t === "training") refreshRuns();
});
// Modes that edit an existing track need a source-audio upload (ref
// mode_ui.py:49 show_src_audio = cover|repaint|extract|lego|complete).
const AUDIO_MODES = ["Remix", "Repaint", "Extract", "Lego", "Complete"];
document.querySelectorAll('input[name=mode]').forEach(r => r.onchange = () => {
  const mode = document.querySelector('input[name=mode]:checked').value;
  $("repaintRow").style.display = (mode === "Repaint") ? "flex" : "none";
  $("audioRow").style.display = AUDIO_MODES.includes(mode) ? "block" : "none";
  $("refRow").style.display = (mode === "Remix") ? "block" : "none";
  $("coverNoiseCol").style.display = (mode === "Remix") ? "block" : "none";
  // ref mode_ui.py:53-54: track_name for Extract/Lego, classes for Complete
  $("trackRow").style.display = (mode === "Extract" || mode === "Lego") ? "block" : "none";
  $("classesRow").style.display = (mode === "Complete") ? "block" : "none";
  // ref mode_ui.py:52,129-134: audio codes only in Custom; cleared on leave
  $("genCodesRow").style.display = (mode === "Custom") ? "block" : "none";
  if (mode !== "Custom") $("gen_codes").value = "";
  // Simple mode: one describe-your-song field drives LM authoring
  $("simpleRow").style.display = (mode === "Simple") ? "block" : "none";
});

// Load params: restore a run from a result's JSON sidecar (ref
// metadata_loading.load_metadata — same field mapping incl. the think-off
// rule when saved audio codes are present).
const TASK_MODE = {text2music: "Custom", cover: "Remix", repaint: "Repaint",
                   extract: "Extract", lego: "Lego", complete: "Complete"};
$("load_params").onchange = () => {
  const f = $("load_params").files[0];
  if (!f) return;
  const rd = new FileReader();
  rd.onload = () => {
    try {
      const md = JSON.parse(rd.result);
      const mode = TASK_MODE[md.task_type] || "Custom";
      const radio = document.querySelector('input[name=mode][value="' + mode + '"]');
      radio.checked = true; radio.dispatchEvent(new Event("change"));
      if (md.caption != null) $("caption").value = md.caption;
      if (md.lyrics != null) $("lyrics").value = md.lyrics;
      if (md.duration != null && md.duration > 0) $("duration").value = md.duration;
      if (md.bpm != null && md.bpm !== "N/A") $("bpm").value = md.bpm;
      if (md.keyscale) $("keyscale").value = md.keyscale;
      if (md.seed != null) $("seed").value = md.seed;
      if (md.batch_size != null) $("batch").value = md.batch_size;
      if (md.inference_steps != null) $("steps").value = md.inference_steps;
      if (md.guidance_scale != null) $("guidance").value = md.guidance_scale;
      if (md.audio_format) $("format").value = md.audio_format;
      if (md.instrumental != null) $("instrumental").checked = !!md.instrumental;
      $("auto_lrc").checked = !!md.auto_lrc;
      $("auto_score").checked = !!md.auto_score;
      if (md.repainting_start != null) $("rstart").value = md.repainting_start;
      if (md.repainting_end != null) $("rend").value = md.repainting_end;
      if (md.audio_cover_strength != null) $("cover_strength").value = md.audio_cover_strength;
      if (md.cover_noise_strength != null) $("cover_noise").value = md.cover_noise_strength;
      if (md.track_name) $("track_name").value = md.track_name;
      if (Array.isArray(md.complete_track_classes))
        $("track_classes").value = md.complete_track_classes.join(", ");
      for (const [k, id] of [["lm_temperature", "lm_temperature"],
                             ["lm_cfg_scale", "lm_cfg_scale"], ["lm_top_k", "lm_top_k"],
                             ["lm_top_p", "lm_top_p"], ["lm_repetition_penalty", "lm_rep_pen"],
                             ["shift", "adv_shift"], ["infer_method", "infer_method"],
                             ["cfg_interval_start", "cfg_start"], ["cfg_interval_end", "cfg_end"],
                             ["vocal_language", "vocal_language"]])
        if (md[k] != null) $(id).value = md[k];
      if (md.use_adg != null) $("use_adg").checked = !!md.use_adg;
      if (md.use_cot_metas != null) $("use_cot_metas").checked = !!md.use_cot_metas;
      if (md.use_cot_caption != null) $("use_cot_caption").checked = !!md.use_cot_caption;
      let think = md.thinking !== false;
      if (md.audio_codes && String(md.audio_codes).trim()) {
        if (mode === "Custom") $("gen_codes").value = md.audio_codes;
        think = false;  // saved codes replay exactly; thinking would regenerate them
      }
      $("thinking").checked = think;
      $("tool_status").textContent = "params loaded from " + f.name;
    } catch (e) { $("tool_status").textContent = "params load error: " + e; }
  };
  rd.readAsText(f);
};

// Instrumental toggle (ref ui_helpers.py:166-179): checked saves the lyrics
// and swaps in [Instrumental]; unchecked restores them.
let savedLyrics = "";
$("instrumental").onchange = () => {
  if ($("instrumental").checked) {
    savedLyrics = $("lyrics").value;
    $("lyrics").value = "[Instrumental]";
  } else {
    $("lyrics").value = savedLyrics || "";
    savedLyrics = "";
  }
};

// Duration of the uploaded source (for repaint-range validation): decode the
// metadata in the browser; falls back to null for formats it can't sniff.
let srcDuration = null;
$("src_file").onchange = () => {
  srcDuration = null; $("src_info").textContent = "";
  const f = $("src_file").files[0];
  if (!f) return;
  const url = URL.createObjectURL(f);
  const a = new Audio();
  a.preload = "metadata";
  a.onloadedmetadata = () => {
    if (isFinite(a.duration)) {
      srcDuration = a.duration;
      $("src_info").textContent = f.name + " — " + a.duration.toFixed(1) + " s";
    } else $("src_info").textContent = f.name;
    URL.revokeObjectURL(url);
  };
  a.onerror = () => { $("src_info").textContent = f.name; URL.revokeObjectURL(url); };
  a.src = url;
};
// API key plumbing (server --api-key): header on XHRs, ?key= on media URLs
// (an <audio src> can't carry headers). Persisted so a reload keeps it.
const apiKey = () => $("api_key").value.trim();
$("api_key").value = localStorage.getItem("acestep_api_key") || "";
$("api_key").onchange = () => localStorage.setItem("acestep_api_key", apiKey());
const authHdrs = (h) => apiKey() ? {...(h || {}), "X-API-Key": apiKey()} : (h || {});
const mediaUrl = (p) => "/v1/audio?path=" + encodeURIComponent(p)
  + (apiKey() ? "&key=" + encodeURIComponent(apiKey()) : "");
async function post(path, body) {
  const r = await fetch(path, {method: "POST",
                               headers: authHdrs({"Content-Type": "application/json"}),
                               body: JSON.stringify(body)});
  return r.json();
}
$("go").onclick = async () => {
  const mode = document.querySelector('input[name=mode]:checked').value;
  // Simple mode (ref simple-mode flow): a one-line description is expanded
  // by the LM into caption/lyrics/metadata before the normal submit; if the
  // LM is unavailable the description becomes the caption directly.
  if (mode === "Simple" && $("simple_query").value.trim()) {
    $("go").disabled = true;  // the draft takes seconds; block double-submit
    $("status").textContent = t("drafting with the LM…");
    try {
      const out = await post("/create_random_sample", {query: $("simple_query").value.trim()});
      const md = out.metadata || {};
      if (md.caption) $("caption").value = md.caption;
      if (md.lyrics && !$("instrumental").checked) $("lyrics").value = md.lyrics;
      if (md.bpm && !$("bpm").value) $("bpm").value = md.bpm;
      if (md.keyscale && !$("keyscale").value) $("keyscale").value = md.keyscale;
      if (md.duration) $("duration").value = md.duration;
    } catch (e) { /* fall through: use the description as the caption */ }
    if (!$("caption").value) $("caption").value = $("simple_query").value.trim();
    $("status").textContent = "";
  }
  const payload = {
    caption: $("caption").value, lyrics: $("lyrics").value,
    duration: parseFloat($("duration").value), seed: parseInt($("seed").value),
    batch_size: parseInt($("batch").value), inference_steps: parseInt($("steps").value),
    guidance_scale: parseFloat($("guidance").value),
    instrumental: $("instrumental").checked,
    thinking: $("thinking").checked, task_type: MODE_TASK[mode],
    audio_format: $("format").value,
    auto_lrc: $("auto_lrc").checked, auto_score: $("auto_score").checked,
    lm_temperature: parseFloat($("lm_temperature").value),
    lm_cfg_scale: parseFloat($("lm_cfg_scale").value),
    lm_top_k: parseInt($("lm_top_k").value),
    lm_top_p: parseFloat($("lm_top_p").value),
    lm_repetition_penalty: parseFloat($("lm_rep_pen").value),
    shift: parseFloat($("adv_shift").value),
    infer_method: $("infer_method").value,
    use_adg: $("use_adg").checked,
    cfg_interval_start: parseFloat($("cfg_start").value),
    cfg_interval_end: parseFloat($("cfg_end").value),
    use_cot_metas: $("use_cot_metas").checked,
    use_cot_caption: $("use_cot_caption").checked,
  };
  if ($("vocal_language").value.trim()) payload.vocal_language = $("vocal_language").value.trim();
  if ($("bpm").value) payload.bpm = parseInt($("bpm").value);
  if ($("keyscale").value) payload.keyscale = $("keyscale").value;
  if (mode === "Custom" && $("gen_codes").value.trim())
    payload.audio_codes = $("gen_codes").value.trim();
  if (mode === "Repaint") {
    payload.repainting_start = parseFloat($("rstart").value);
    payload.repainting_end = parseFloat($("rend").value);
  }
  const needsAudio = AUDIO_MODES.includes(mode);
  if (needsAudio) {
    if (!$("src_file").files[0]) {
      $("status").textContent = t("This mode needs a source audio file"); return;
    }
    payload.audio_cover_strength = parseFloat($("cover_strength").value);
    if (mode === "Remix") payload.cover_noise_strength = parseFloat($("cover_noise").value);
    if ((mode === "Extract" || mode === "Lego") && $("track_name").value.trim())
      payload.track_name = $("track_name").value.trim();
    if (mode === "Complete" && $("track_classes").value.trim())
      payload.complete_track_classes =
        $("track_classes").value.split(",").map(s => s.trim()).filter(Boolean);
    if (mode === "Repaint" && srcDuration != null) {
      const rs = payload.repainting_start, re = payload.repainting_end;
      if (rs < 0 || rs >= srcDuration) {
        $("status").textContent = "repaint start outside the uploaded audio (0–"
          + srcDuration.toFixed(1) + " s)"; return;
      }
      if (re !== -1 && (re <= rs || re > srcDuration + 0.05)) {
        $("status").textContent = "repaint end must be in (" + rs + ", "
          + srcDuration.toFixed(1) + "] s or -1"; return;
      }
    }
  }
  $("go").disabled = true; $("bar").style.display = "block";
  $("status").textContent = "submitting…";
  try {
    let resp;
    if (needsAudio) {
      // multipart /release_task: file parts become server temp paths
      // (src_audio, repeated reference_audio), scalars JSON-coerced.
      const fd = new FormData();
      Object.entries(payload).forEach(([k, v]) => fd.append(k, JSON.stringify(v)));
      fd.append("src_audio", $("src_file").files[0]);
      [...$("ref_files").files].forEach(f => fd.append("reference_audio", f));
      resp = await (await fetch("/release_task", {method: "POST", headers: authHdrs(), body: fd})).json();
    } else {
      resp = await post("/release_task", payload);
    }
    const task_id = resp.task_id;
    // 429 queue-full / validation error: surface it instead of polling null
    // (the throw lands in the catch below, which re-enables the button).
    if (!task_id) throw (resp.error || "submit failed");
    $("status").textContent = "queued: " + task_id;
    for (;;) {
      await new Promise(res => setTimeout(res, 1500));
      const out = await post("/query_result", {task_ids: [task_id]});
      const st = out.results[0];
      $("bar").value = st.progress || 0;
      if (st.status === 1) {
        $("status").textContent = "done";
        const div = document.createElement("div"); div.className = "result";
        (st.result.audio_paths || []).forEach((p, i) => {
          const a = document.createElement("audio"); a.controls = true;
          a.src = mediaUrl(p);
          const cap = document.createElement("div"); cap.className = "small";
          let capText = p + "  seed=" + (st.result.seeds || [])[i];
          const score = (st.result.lyrics_scores || [])[i];
          if (score != null) capText += "  lyric score " + Number(score).toFixed(3);
          cap.textContent = capText;
          div.appendChild(cap); div.appendChild(a);
          // Send this result back as the source of an edit mode (the ref UI's
          // send_audio_to_remix / send_audio_to_repaint actions).
          const sendTo = (label, modeName) => {
            const send = document.createElement("button");
            send.dataset.noI18n = "";
            send.textContent = t(label);
            send.style.fontSize = ".75rem"; send.style.padding = ".25rem .6rem";
            send.style.marginRight = ".4rem";
            send.onclick = async () => {
              const blob = await (await fetch(a.src, {headers: authHdrs()})).blob();
              const name = p.split("/").pop() || "result.wav";
              const dt = new DataTransfer();
              dt.items.add(new File([blob], name, {type: blob.type || "audio/wav"}));
              $("src_file").files = dt.files;
              const radio = document.querySelector('input[name=mode][value="' + modeName + '"]');
              radio.checked = true;
              radio.dispatchEvent(new Event("change"));
              $("src_file").dispatchEvent(new Event("change"));
              window.scrollTo({top: 0, behavior: "smooth"});
            };
            div.appendChild(send);
          };
          sendTo("Send to Remix", "Remix");
          sendTo("Send to Repaint", "Repaint");
          const pp = (st.result.params_paths || [])[i];
          if (pp) {
            const link = document.createElement("a");
            link.className = "small";
            link.style.marginLeft = ".6rem";
            link.href = mediaUrl(pp);
            link.download = pp.split("/").pop();
            link.textContent = "params.json";
            div.appendChild(link);
          }
          const lrc = (st.result.lrcs || [])[i];
          if (lrc) {
            const det = document.createElement("details");
            const sum = document.createElement("summary");
            sum.className = "small"; sum.textContent = "LRC";
            const pre = document.createElement("pre");
            pre.className = "small"; pre.textContent = lrc;
            det.appendChild(sum); det.appendChild(pre); div.appendChild(det);
          }
        });
        const meta = document.createElement("pre"); meta.className = "small";
        meta.textContent = st.result.metas || "";
        div.appendChild(meta);
        $("results").prepend(div);
        break;
      }
      if (st.status === 2) { $("status").textContent = "failed: " + (st.error || "").slice(0, 400); break; }
      $("status").textContent = "running… " + Math.round((st.progress || 0) * 100) + "%";
    }
  } catch (e) { $("status").textContent = "error: " + e; }
  $("go").disabled = false; $("bar").style.display = "none";
};

// ---- Understand / create / format tools (ref UI understand-create-format
// surface; endpoints /create_random_sample /format_input /understand) ----
$("btn_example").onclick = async () => {
  $("tool_status").textContent = "sampling example…";
  try {
    const out = await (await fetch("/v1/example", {headers: authHdrs()})).json();
    const md = out.example || {};
    if (md.caption) $("caption").value = md.caption;
    if (md.lyrics != null) $("lyrics").value = md.lyrics;
    if (md.bpm) $("bpm").value = md.bpm;
    if (md.keyscale) $("keyscale").value = md.keyscale;
    if (md.duration) $("duration").value = md.duration;
    if (md.think != null) $("thinking").checked = !!md.think;
    $("tool_status").textContent = "example loaded";
  } catch (e) { $("tool_status").textContent = "error: " + e; }
};
$("btn_create").onclick = async () => {
  $("tool_status").textContent = "creating…";
  try {
    const out = await post("/create_random_sample", {});
    const md = out.metadata || {};
    if (md.caption) $("caption").value = md.caption;
    if (md.lyrics) $("lyrics").value = md.lyrics;
    $("tool_status").textContent = "sample created";
  } catch (e) { $("tool_status").textContent = "error: " + e; }
};
$("btn_format").onclick = async () => {
  $("tool_status").textContent = "formatting…";
  try {
    const out = await post("/format_input",
      {user_input: $("caption").value + "\\n" + $("lyrics").value});
    const md = out.metadata || {};
    if (md.caption) $("caption").value = md.caption;
    if (md.lyrics) $("lyrics").value = md.lyrics;
    $("tool_status").textContent = "formatted";
  } catch (e) { $("tool_status").textContent = "error: " + e; }
};
$("btn_understand").onclick = async () => {
  if ($("understandRow").style.display === "none") {
    $("understandRow").style.display = "block";
    if (!$("u_codes").value) return;
  }
  $("tool_status").textContent = "understanding…";
  try {
    const out = await post("/understand", {audio_codes: $("u_codes").value});
    if (out.caption) $("caption").value = out.caption;
    if (out.lyrics) $("lyrics").value = out.lyrics;
    $("tool_status").textContent = JSON.stringify(
      {bpm: out.bpm, duration: out.duration, keyscale: out.keyscale, language: out.language});
  } catch (e) { $("tool_status").textContent = "error: " + e; }
};

// ---- Dataset explorer (interactive annotation editor driving the stateful
// /v1/dataset/* routes: scan/load/edit/save + async auto_label/preprocess
// with task polling — ref training-tab annotation flow) ----
async function dsReq(method, path, body) {
  const r = await fetch(path, {method, headers: authHdrs({"Content-Type": "application/json"}),
                               body: body === undefined ? undefined : JSON.stringify(body)});
  return r.json();
}
function dsCell(idx, field, value, wide) {
  const inp = document.createElement(wide ? "textarea" : "input");
  if (!wide) inp.type = "text";
  inp.value = value == null ? "" : value;
  inp.style.minHeight = wide ? "2.2em" : "";
  inp.onchange = async () => {
    const out = await dsReq("PUT", "/v1/dataset/sample/" + idx, {[field]: inp.value});
    $("dx_status").textContent = out.success ? ("saved " + field + " for sample " + idx)
                                             : ("error: " + out.error);
  };
  return inp;
}
function renderDsTable(samples) {
  const box = $("dx_table"); box.innerHTML = "";
  samples.forEach((s, i) => {
    const div = document.createElement("div"); div.className = "result";
    const head = document.createElement("div"); head.className = "small";
    head.textContent = "#" + i + "  " + (s.filename || s.audio_path) + "  ["
      + (s.label_source || (s.labeled ? "labeled" : "unlabeled")) + "]"
      + (s.duration ? ("  " + Number(s.duration).toFixed(1) + "s") : "");
    div.appendChild(head);
    const row = document.createElement("div"); row.className = "row";
    const cap = document.createElement("div"); cap.style.flex = "3";
    cap.appendChild(dsCell(i, "caption", s.caption));
    const bpm = document.createElement("div");
    bpm.appendChild(dsCell(i, "bpm", s.bpm));
    const key = document.createElement("div");
    key.appendChild(dsCell(i, "keyscale", s.keyscale));
    row.appendChild(cap); row.appendChild(bpm); row.appendChild(key);
    div.appendChild(row);
    const det = document.createElement("details");
    const sum = document.createElement("summary"); sum.className = "small";
    sum.textContent = "lyrics"; det.appendChild(sum);
    det.appendChild(dsCell(i, "lyrics", s.lyrics, true));
    div.appendChild(det);
    box.appendChild(div);
  });
  if (!samples.length) box.innerHTML = '<div class="small">no samples</div>';
}
async function dsRefresh() {
  const out = await dsReq("GET", "/v1/dataset/samples");
  if (out.success) renderDsTable(out.samples);
  return out;
}
$("dx_scan").onclick = async () => {
  $("dx_status").textContent = "scanning…";
  const out = await dsReq("POST", "/v1/dataset/scan", {directory: $("dx_dir").value});
  $("dx_status").textContent = out.success ? out.message : ("error: " + out.error);
  if (out.success) renderDsTable(out.samples);
};
$("dx_load").onclick = async () => {
  const out = await dsReq("POST", "/v1/dataset/load",
    $("dx_labels").value ? {path: $("dx_labels").value} : {directory: $("dx_dir").value});
  $("dx_status").textContent = out.success ? (out.total_samples + " samples loaded")
                                           : ("error: " + out.error);
  if (out.success) renderDsTable(out.samples);
};
$("dx_save").onclick = async () => {
  const out = await dsReq("POST", "/v1/dataset/save",
    $("dx_labels").value ? {path: $("dx_labels").value} : {});
  $("dx_status").textContent = out.success ? ("saved " + out.path) : ("error: " + out.error);
};
async function dsPollTask(kind, task_id) {
  for (;;) {
    await new Promise(res => setTimeout(res, 1200));
    const st = await dsReq("GET", "/v1/dataset/" + kind + "_status/" + task_id);
    if (!st.success) return st;
    const prog = (st.total ? (st.current + "/" + st.total + "  ") : "") + (st.message || "");
    if (st.status === "completed" || st.status === "failed") return st;
    $("dx_status").textContent = kind + " running… " + prog;
  }
}
$("dx_label").onclick = async () => {
  $("dx_status").textContent = "labeling…";
  const out = await dsReq("POST", "/v1/dataset/auto_label_async", {skip_labeled: true});
  if (!out.success) { $("dx_status").textContent = "error: " + out.error; return; }
  const st = await dsPollTask("auto_label", out.task_id);
  $("dx_status").textContent = st.status === "completed"
    ? ("labeled " + (st.result.labeled || 0) + "/" + (st.result.total || 0))
    : ("error: " + (st.error || JSON.stringify(st)));
  dsRefresh();
};
$("dx_prep").onclick = async () => {
  $("dx_status").textContent = "preprocessing…";
  const body = {};
  if ($("ds_out_dir").value) body.output_dir = $("ds_out_dir").value;
  const out = await dsReq("POST", "/v1/dataset/preprocess_async", body);
  if (!out.success) { $("dx_status").textContent = "error: " + out.error; return; }
  const st = await dsPollTask("preprocess", out.task_id);
  if (st.status === "completed") {
    $("dx_status").textContent = "wrote " + st.result.written + "/" + st.result.total
      + " → " + st.result.output_dir;
    if (!$("tr_dataset").value) $("tr_dataset").value = st.result.output_dir;
  } else $("dx_status").textContent = "error: " + (st.error || JSON.stringify(st));
};

// ---- Training tab (drives /v1/train/* — ref train UI tab parity) ----
$("build_ds").onclick = async () => {
  $("ds_status").textContent = "building…";
  try {
    const out = await post("/v1/train/build_dataset",
      {audio_dir: $("ds_audio_dir").value, output_dir: $("ds_out_dir").value,
       label_with_lm: $("ds_label_lm").checked,
       format_lyrics: $("ds_format_lyrics").checked});
    $("ds_status").textContent = (out.scan || "") + " — " + (out.status || JSON.stringify(out));
    // Annotation preview table (labels per sample from sidecar/CSV/LM)
    const box = $("ds_labels"); box.innerHTML = "";
    (out.labels || []).forEach(l => {
      const d = document.createElement("div");
      d.textContent = l.file + " [" + (l.source || "none") + "] "
        + (l.caption || "").slice(0, 80)
        + (l.bpm ? ("  bpm " + l.bpm) : "") + (l.keyscale ? ("  " + l.keyscale) : "");
      box.appendChild(d);
    });
    if (out.output_dir && !$("tr_dataset").value) $("tr_dataset").value = out.output_dir;
  } catch (e) { $("ds_status").textContent = "error: " + e; }
};
$("tr_start").onclick = async () => {
  $("tr_status").textContent = "starting…";
  const payload = {
    dataset_dir: $("tr_dataset").value,
    rank: parseInt($("tr_rank").value), alpha: parseFloat($("tr_alpha").value),
    learning_rate: parseFloat($("tr_lr").value), max_steps: parseInt($("tr_steps").value),
    batch_size: parseInt($("tr_batch").value), checkpoint_every: parseInt($("tr_ckpt").value),
    seed: parseInt($("tr_seed").value),
  };
  if ($("tr_out").value) payload.output_dir = $("tr_out").value;
  try {
    const out = await post("/v1/train/start", payload);
    $("tr_status").textContent = out.run_id ? ("run started: " + out.run_id)
                                            : JSON.stringify(out);
    refreshRuns();
  } catch (e) { $("tr_status").textContent = "error: " + e; }
};
async function refreshRuns() {
  try {
    const runs = await post("/v1/train/list", {});
    const box = $("tr_runs"); box.innerHTML = "";
    Object.entries(runs).forEach(([id, st]) => {
      const div = document.createElement("div"); div.className = "result";
      const line = document.createElement("div");
      line.textContent = id + " — " + st.status + "  step " + (st.step || 0)
        + (st.loss != null ? ("  loss " + Number(st.loss).toFixed(4)) : "")
        + (st.error ? ("  error: " + String(st.error).slice(0, 120)) : "");
      div.appendChild(line);
      const small = document.createElement("div"); small.className = "small";
      small.textContent = st.output_dir || "";
      div.appendChild(small);
      // Loss sparkline from metrics.jsonl (the TensorBoard-equivalent view):
      // single series — 2px line, no legend (the row label names it), value
      // in text ink, recessive on the card surface.
      post("/v1/train/status", {run_id: id}).then(full => {
        const pts = (full.recent_metrics || []).map(m => m.loss).filter(v => v != null);
        if (pts.length < 2) return;
        const W = 160, H = 28, lo = Math.min(...pts), hi = Math.max(...pts);
        const xy = pts.map((v, i) => [
          (i / (pts.length - 1)) * (W - 4) + 2,
          H - 2 - ((hi - lo) > 1e-12 ? (v - lo) / (hi - lo) : 0.5) * (H - 4),
        ]);
        const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
        svg.setAttribute("width", W); svg.setAttribute("height", H);
        svg.style.verticalAlign = "middle";
        const pl = document.createElementNS("http://www.w3.org/2000/svg", "polyline");
        pl.setAttribute("points", xy.map(p => p.map(c => c.toFixed(1)).join(",")).join(" "));
        pl.setAttribute("fill", "none");
        pl.setAttribute("stroke", "#6ae3ff");
        pl.setAttribute("stroke-width", "2");
        pl.setAttribute("stroke-linejoin", "round");
        const title = document.createElementNS("http://www.w3.org/2000/svg", "title");
        title.textContent = "loss " + pts[pts.length - 1].toFixed(4)
          + " (min " + lo.toFixed(4) + ", max " + hi.toFixed(4) + ", last "
          + pts.length + " steps)";
        svg.appendChild(title); svg.appendChild(pl);
        const wrap = document.createElement("div"); wrap.className = "small";
        wrap.appendChild(svg);
        const lbl = document.createElement("span");
        lbl.textContent = " loss " + pts[pts.length - 1].toFixed(4);
        wrap.appendChild(lbl);
        div.appendChild(wrap);
      }).catch(() => {});
      if (st.status === "running" || st.status === "starting") {
        const stop = document.createElement("button");
        stop.dataset.noI18n = "";  // applyLang must not record translated text as English
        stop.textContent = t("Stop");
        stop.onclick = async () => { await post("/v1/train/stop", {run_id: id}); refreshRuns(); };
        div.appendChild(stop);
      }
      box.appendChild(div);
    });
    if (!Object.keys(runs).length) box.innerHTML = '<div class="small">no runs yet</div>';
  } catch (e) { $("tr_runs").textContent = "error: " + e; }
}
$("tr_refresh").onclick = refreshRuns;
$("lang").onchange = applyLang;
setInterval(() => {
  if (document.querySelector('input[name=tab]:checked').value === "training") refreshRuns();
}, 4000);
</script>
</body>
</html>
"""
